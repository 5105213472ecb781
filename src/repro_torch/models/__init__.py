"""The LM scaffold's models (the port of ``repro.models``): config,
layers, attention, Mamba2, MoE, the model assembly and the conversion of
the reference's parameters.  Prefill attention and the Mamba2 scan go
through ``kernels.ops``; the rest is plain PyTorch."""
