# Hand-written Hopper kernels of the port, one package per TPU kernel of
# src/repro/kernels. Each holds ref.py (the plain PyTorch version, the
# CPU path), ops.py (the wrapper: the tensors' device picks the kernel)
# and csrc/ (CUDA C++ for sm_90a, built by _build.py at first use):
#   hype_score -- fused external-neighbours score + per-phase select,
#                 and the plain external-neighbours score
#   kway_refine -- k-way move gains of the refinement post-pass
