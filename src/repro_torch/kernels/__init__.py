"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

sgs_decode: serial-SGS decode, the SA inner loop (csrc/sgs_decode.cu;
            bit-exact against ref.sgs_decode_ref)
ops:        dispatch by the tensors' device; ref: plain PyTorch versions
"""
