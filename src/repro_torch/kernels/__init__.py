"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

sgs_decode:      serial-SGS decode, the SA inner loop (csrc/sgs_decode.cu)
sched_violation: capacity-violation mass, the ising engine's energy term
                 (csrc/sched_violation.cu)
usl_runtime:     USL runtime grid, paper Eq. 9 (csrc/usl_runtime.cu)
_build:          one nvcc build per source at first use, ctypes loading
ops:             dispatch by the tensors' device; ref: plain PyTorch
                 versions, each kernel bit-exact against its own
"""
