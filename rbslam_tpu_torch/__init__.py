"""rbslam_tpu_torch — the PyTorch + CUDA port of rbslam_tpu for NVIDIA Hopper.

A second package beside the JAX reference (``rbslam_tpu``), with the same
module layout and public names. It imports torch and numpy, never jax.
The filter's hot-path kernels are hand-written CUDA (``csrc/``), built
with nvcc for sm_90a at first use; each has a plain PyTorch version that
tensors on the CPU take.

Subpackages
-----------
math      quaternion algebra, log-weight utilities
basis     Laplacian eigenbasis, scalar-potential basis, spectral densities
ops       systematic resampling, small-ny Kalman update
kernels   CUDA kernels K1-K4 with wrappers, plain versions, launch counts
models    dense 3-D magnetic-field model
engines   RBPF, factored-covariance (lowrank) path
data      bean_6D trajectory, curl-free field draw, dataset simulation
workloads the flagship dense-mag problem
utils     problem construction from numpy arrays
"""

__version__ = "0.1.0"
