"""rbslam_tpu_torch — the PyTorch + CUDA port of rbslam_tpu for NVIDIA Hopper.

A second package beside the JAX reference (``rbslam_tpu``), with the same
module layout and public names. It imports torch and numpy, never jax.
The kernels are hand-written CUDA (``csrc/``), built with nvcc for sm_90a
at first use; each has a plain PyTorch version that tensors on the CPU
take.

Subpackages
-----------
math      quaternion algebra, PSD-safe Cholesky, log-weight utilities,
          Procrustes alignment
basis     Laplacian eigenbasis, scalar-potential basis, spectral densities
gp        reduced-rank GP regression with ML-II fitting (the magnetic map)
ops       resampling schemes, dense and masked (sparse) Kalman updates
kernels   CUDA kernels K1-K7 with wrappers, plain versions, launch counts
models    dense 3-D magnetic-field and radio models, terrain-matching
          models, pinhole camera
engines   RBPF (xla, block_gather, lowrank; sparse models), plain PF,
          CPF-AS and information-form smoothers, EKF
data      trajectories, GP field draws, dataset simulation, the sparse
          visual dataset
metrics   Procrustes-aligned position, orientation, path and map RMSE
workloads dense-mag, dense-radio, mag-localization and sparse-visual
          problems, GPU profilers
parallel  the (particles, map) mesh on torch.distributed: sharded
          resampling, map-axis algebra, process-group bootstrap
utils     problem construction from numpy arrays
"""

__version__ = "0.1.0"
