"""Serving layer of the port: the FedAttn engine (prefill + decode), the
continuous-batching pool and the block-paged KV allocator / prefix cache
backing it.

Exports resolve lazily, so that the leaf modules (:mod:`.paging`,
:mod:`.quant`) can be imported by the kernel and model layers without
importing the engine, which imports those layers in turn.
"""

_EXPORTS = {
    "FedAttnEngine": "repro_torch.serving.engine",
    "GenerationResult": "repro_torch.serving.engine",
    "ContinuousBatchingScheduler": "repro_torch.serving.scheduler",
    "Request": "repro_torch.serving.scheduler",
    "PageAllocator": "repro_torch.serving.paging",
    "PrefixCache": "repro_torch.serving.paging",
    "NGramDrafter": "repro_torch.serving.spec",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch.serving' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
