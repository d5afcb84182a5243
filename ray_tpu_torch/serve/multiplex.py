"""Model multiplexing: many models share one replica pool.

Reference: python/ray/serve/multiplex.py:22 (``_ModelMultiplexWrapper``
— per-replica LRU of loaded model callables) + serve/api.py
``@serve.multiplexed`` / ``serve.get_multiplexed_model_id`` +
pow-2 router model affinity (replica_scheduler/pow_2_scheduler.py:52).

TPU note: this is the multi-LoRA serving shape — one base-model
replica pool, per-request adapter ids, LRU'd adapter weights per
replica, and router affinity so a given adapter's requests land where
its weights are already resident instead of thrashing HBM.

Usage::

    @serve.deployment(num_replicas=2)
    class M:
        @serve.multiplexed(max_num_models_per_replica=3)
        def get_model(self, model_id: str):
            return load_model(model_id)          # arbitrary callable

        def __call__(self, x):
            model = self.get_model(serve.get_multiplexed_model_id())
            return model(x)

    handle.options(multiplexed_model_id="m1").remote(x)
"""

from __future__ import annotations

import contextvars
import threading
from collections import OrderedDict
from typing import Any, Callable

_current_model_id: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """The model id of the request being handled (empty outside a
    multiplexed request)."""
    return _current_model_id.get()


def _set_model_id(model_id: str):
    return _current_model_id.set(model_id or "")


def _reset_model_id(token) -> None:
    _current_model_id.reset(token)


def multiplexed(max_num_models_per_replica: int = 3) -> Callable:
    """Wrap a model-loader method with a per-replica LRU cache.

    The wrapped method loads at most ``max_num_models_per_replica``
    models; loading one more evicts the least recently used (calling
    its ``__del__`` via release, or an ``unload()`` method if the
    model defines one)."""
    if max_num_models_per_replica < 1:
        raise ValueError("max_num_models_per_replica must be >= 1")

    def decorator(loader: Callable) -> Callable:
        import inspect

        if inspect.iscoroutinefunction(loader):
            raise TypeError(
                "@serve.multiplexed loaders must be sync functions "
                "here (an async loader's coroutine would be cached "
                "and awaited twice); load synchronously")
        lock = threading.Lock()
        cache_attr = f"_serve_mux_cache_{loader.__name__}"

        def wrapper(self, model_id: str) -> Any:
            # The cache lives ON the instance (an id(self)-keyed module
            # dict would both leak dead instances and hand a recycled
            # address another instance's models).
            cache = self.__dict__.get(cache_attr)
            if cache is None:
                cache = self.__dict__.setdefault(cache_attr,
                                                 OrderedDict())
            with lock:
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
            model = loader(self, model_id)
            with lock:
                cache[model_id] = model
                cache.move_to_end(model_id)
                evicted = []
                while len(cache) > max_num_models_per_replica:
                    _mid, old = cache.popitem(last=False)
                    evicted.append(old)
            for old in evicted:
                # Paged-KV release first: a model holding blocks in a
                # shared KV allocator (multi-LoRA serving) must hand
                # them back on eviction — its table/prefix-trie holds
                # otherwise outlive the model until process exit (the
                # classic multiplex leak).
                from .kv_cache import release_model_kv

                release_model_kv(old)
                unload = getattr(old, "unload", None)
                if callable(unload):
                    try:
                        unload()
                    except Exception:
                        pass
            return model

        wrapper.__name__ = getattr(loader, "__name__", "get_model")
        wrapper.__wrapped__ = loader
        wrapper._serve_multiplexed = True
        return wrapper

    return decorator
