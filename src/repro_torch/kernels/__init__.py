"""Hand-written CUDA kernels, each beside its plain PyTorch version
(``dso_sparse`` for the block-ELL and K-bucketed layouts, ``dso_update``
for the dense layout, the two-pass tile step and the shared Eq.-8 tail,
``swa_attention`` and ``ssd_scan`` for sliding-window attention and the
Mamba2 SSD scan), their build (``build``: every ``csrc/*.cu`` into one
library), the wrappers that route a tensor to one or the other (``ops``:
``ops.swa_attention``, ``ops.ssd_scan``, ``ops.dso_tile_step`` and the
rest) and the independent oracles the tests hold them against (``ref``).

The wrappers are not re-exported here: ``swa_attention`` and ``ssd_scan``
name the submodules of this package."""
