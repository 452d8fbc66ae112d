"""The coprocessor: CopDAG and FragmentDAG requests as PyTorch programs
and hand-written CUDA kernels."""
