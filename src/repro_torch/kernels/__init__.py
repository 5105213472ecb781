"""Hand-written CUDA kernels for the DSO block step, each beside its plain
PyTorch version (``dso_sparse``), the shared Eq.-8 tail (``dso_update``),
the wrappers that route a tensor to one or the other (``ops``) and the
independent oracles the tests hold them against (``ref``)."""
