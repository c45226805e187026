"""The LM scaffolding (port of ``repro/models``): configs, the dense
decoder's layers, attention and the backbone, as plain functions on dicts
of tensors."""
