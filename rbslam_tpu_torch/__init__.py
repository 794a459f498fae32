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
ops       resampling schemes, small-ny Kalman update
kernels   CUDA kernels K1-K7 with wrappers, plain versions, launch counts
models    dense 3-D magnetic-field model, dense radio model
engines   RBPF (xla, block_gather, lowrank), CPF-AS and information-form
          smoothers
data      trajectories, GP field draws, dataset simulation
metrics   Procrustes-aligned position RMSE
workloads dense-mag and dense-radio problems, GPU profilers
utils     problem construction from numpy arrays
"""

__version__ = "0.1.0"
