"""Entry points of the port: the training loop
(``repro_torch.launch.train.train``, ``python -m repro_torch.launch.train``)
and the serving loop (``repro_torch.launch.serve.serve``).

The names ``train`` and ``serve`` here are the submodules: binding the
functions to them would make ``import repro_torch.launch.serve as m`` give
a function.  The training module's other names are exported lazily, so
``python -m repro_torch.launch.train`` does not import the module twice.
"""
__all__ = ["PRESET_100M", "TINY", "per_slot_lm_loss"]


def __getattr__(name):
    if name in __all__:
        from repro_torch.launch import train
        return getattr(train, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
