"""Hand-written CUDA kernels for the DSO block step, each beside its plain
PyTorch version (``dso_sparse`` for the block-ELL and K-bucketed layouts,
``dso_update`` for the dense layout and the shared Eq.-8 tail), their
build (``build``: every ``csrc/*.cu`` into one library), the wrappers that
route a tensor to one or the other (``ops``) and the independent oracles
the tests hold them against (``ref``)."""
