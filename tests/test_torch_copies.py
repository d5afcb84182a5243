"""The port's copies of the JAX package's framework-agnostic modules
stay copies.

Every copied file is a row of :data:`COPIES`: its path under
``ray_tpu_torch/`` (the same path under ``ray_tpu/`` is its original)
and the hunks it may differ by, each with its reason.  The test
normalises only the package path of the port's file (``ray_tpu_torch.``,
``import ray_tpu_torch``, ``from ray_tpu_torch`` -> ``ray_tpu``), applies
the hunks to the original, and asserts that the two are then identical.
A hunk names the original text (``ref``, which must occur exactly once)
and what the port has in its place (``port``).  Names in string literals
(metric names, ``RAY_TPU_*`` variables, thread and logger names) keep
the original's spelling, so they are never hunks.

The port's files that have an original but are not copies are listed in
:data:`REWRITTEN` with the reason, so that no file drifts from its
original unlisted.
"""

import difflib
import pathlib
from typing import NamedTuple

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "ray_tpu_torch"
REF = ROOT / "ray_tpu"


class Hunk(NamedTuple):
    reason: str
    ref: str
    port: str


def normalise(text: str) -> str:
    return (text.replace("ray_tpu_torch.", "ray_tpu.")
            .replace("import ray_tpu_torch", "import ray_tpu")
            .replace("from ray_tpu_torch", "from ray_tpu"))


COPIES = {
    "_version.py": [],
    "exceptions.py": [],
    "core/ids.py": [],
    "core/config.py": [],
    "core/deadlines.py": [],
    "core/task_spec.py": [
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref='    num_tpus: Optional[float] = None\n',
             port='    num_gpus: Optional[float] = None\n'),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref=('        if self.num_tpus:\n'
                  '            demand["TPU"] = self.num_tpus\n'),
             port=('        if self.num_gpus:\n'
                   '            demand["GPU"] = self.num_gpus\n')),
    ],
    "core/object_ref.py": [],
    "core/reference_count.py": [],
    "core/streaming.py": [],
    "core/runtime_context.py": [],
    "experimental/chaos.py": [
        Hunk("comment: the JAX package's change-history reference dropped (the port has its own history)",
             ref='    # Control-plane chaos (PR 8): head kill -9, node partitions,\n',
             port='    # Control-plane chaos: head kill -9, node partitions,\n'),
        Hunk("comment: the JAX package's change-history reference dropped (the port has its own history)",
             ref="    # Control-plane chaos (PR 8): the vcluster soak's fault model —\n",
             port="    # Control-plane chaos: the vcluster soak's fault model —\n"),
    ],
    "observability/__init__.py": [],
    "observability/tracing.py": [],
    "observability/profiling.py": [
        Hunk("comment: the JAX package's change-history reference dropped (the port has its own history)",
             ref="The **stuck detector** closes the loop with PR 5's deadline plane:\n",
             port='The **stuck detector** closes the loop with the deadline plane:\n'),
    ],
    "observability/timeline.py": [],
    "observability/logs.py": [],
    "observability/flightrec.py": [],
    "observability/metrics.py": [],
    "core/object_store.py": [
        Hunk("docstring or comment: the reference's TPU/jax statement is false for the port",
             ref=('TPU note: values may be ``jax.Array``s.  They are kept by reference (no\n'
                  'copy, no host transfer) so HBM-resident arrays flow between tasks on the\n'
                  'same process at zero cost; cross-process transfer goes through the\n'
                  'serialization layer which devices-gets only at the boundary.\n'),
             port=('Values may hold ``torch.Tensor``s, CUDA ones included.  They stay on\n'
                   'their device (no host transfer) but are cloned there at seal and at\n'
                   'every read, because a tensor is mutable (cluster/serialization.py);\n'
                   'cross-process transfer goes through the serialization layer, which\n'
                   'copies to the host only at the boundary.\n')),
        Hunk("docstring or comment: the reference's TPU/jax statement is false for the port",
             ref=("    consumer's (reference plasma semantics).  Array leaves are shared —\n"
                  '    jax.Arrays by reference (immutable), numpy as frozen read-only\n'
                  '    copies.\n'),
             port=("    consumer's (reference plasma semantics).  numpy leaves are shared\n"
                   '    as frozen read-only copies; tensor leaves are cloned on their\n'
                   '    device at every access.\n')),
    ],
    "core/plasma.py": [
        Hunk("docstring or comment: the reference's TPU/jax statement is false for the port",
             ref=('TPU-first note: values are stored as ``Serialized`` (payload bytes +\n'
                  'live array externs).  Same-process consumers share the arrays at zero\n'
                  'cost; building the wire layout is zero-copy for host numpy externs and\n'
                  'pays exactly one device→host transfer for ``jax.Array`` externs, cached\n'
                  'for the lifetime of the entry.\n'),
             port=('Values are stored as ``Serialized`` (payload bytes + live array\n'
                   'externs).  Same-process consumers share numpy externs at zero cost and\n'
                   'clone tensor externs on their device; building the wire layout is\n'
                   'zero-copy for host numpy externs and pays exactly one device→host\n'
                   'transfer for a CUDA tensor extern, cached for the lifetime of the\n'
                   'entry.\n')),
    ],
    "core/scheduler.py": [],
    "core/task_manager.py": [],
    "core/actor_runtime.py": [
        Hunk('cluster mode is not in this slice: isolate=True raises NotImplementedError',
             ref=('                from .isolated_pool import IsolatedInstance\n'
                  '\n'
                  '                self.instance = IsolatedInstance(\n'
                  '                    self._runtime.isolated_pool, info.klass,\n'
                  '                    info.init_args, info.init_kwargs)\n'),
             port=('                raise NotImplementedError(\n'
                   '                    "isolate=True is not ported yet "\n'
                   '                    "(ROADMAP queue A item 4, cluster sub-slice)")\n')),
        Hunk("a dead actor lets go of its instance and constructor arguments, so a model's tensors on the card are freed at kill (serve.delete)",
             ref=('        core.stop()\n'
                  '        with self._lock:\n'),
             port=('        core.stop()\n'
                   '        # The dead core stays (it answers later calls with the typed\n'
                   '        # death error) but lets go of the instance and its constructor\n'
                   "        # arguments: a model's tensors on the card are freed at kill.\n"
                   '        core.instance = None\n'
                   '        info.init_args, info.init_kwargs = (), {}\n'
                   '        with self._lock:\n')),
    ],
    "core/actor.py": [
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref=('    "max_concurrency", "max_pending_calls", "num_cpus", "num_tpus",\n'
                  '    "num_gpus", "resources", "memory", "scheduling_strategy",\n'),
             port=('    "max_concurrency", "max_pending_calls", "num_cpus", "num_gpus",\n'
                   '    "resources", "memory", "scheduling_strategy",\n')),
        Hunk('cluster mode is not in this slice: the DAG API (.bind) raises NotImplementedError',
             ref=('        from ..dag.dag_node import ClassNode\n'
                  '\n'
                  '        return ClassNode(self, args, kwargs)\n'),
             port=('        raise NotImplementedError(\n'
                   '            "the DAG API is not ported yet "\n'
                   '            "(ROADMAP queue A item 4, cluster sub-slice)")\n')),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref=('        num_tpus = merged.get("num_tpus")\n'
                  '        if num_tpus is None and merged.get("num_gpus") is not None:\n'
                  '            num_tpus = merged["num_gpus"]\n'),
             port=""),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref='            num_tpus=num_tpus,\n',
             port='            num_gpus=merged.get("num_gpus"),\n'),
        Hunk('cluster mode is not in this slice: the DAG API (.bind) raises NotImplementedError',
             ref=('        from ..dag.dag_node import ClassNode\n'
                  '\n'
                  '        return ClassNode(self._actor_class, args, kwargs, self._overrides)\n'),
             port=('        raise NotImplementedError(\n'
                   '            "the DAG API is not ported yet "\n'
                   '            "(ROADMAP queue A item 4, cluster sub-slice)")\n')),
        Hunk('cluster mode is not in this slice: the DAG API (.bind) raises NotImplementedError',
             ref=('        from ..dag.dag_node import ClassMethodNode\n'
                  '\n'
                  '        return ClassMethodNode(self._handle, self._method_name, args, kwargs)\n'),
             port=('        raise NotImplementedError(\n'
                   '            "the DAG API is not ported yet "\n'
                   '            "(ROADMAP queue A item 4, cluster sub-slice)")\n')),
    ],
    "core/remote_function.py": [
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref='    "num_returns", "num_cpus", "num_tpus", "num_gpus", "resources",\n',
             port='    "num_returns", "num_cpus", "num_gpus", "resources",\n'),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus); num_gpus is no longer an alias',
             ref=('    # num_gpus is accepted as an alias for TPU-less portability of user\n'
                  '    # code; it maps onto the generic accelerator resource.\n'
                  '    num_tpus = merged.get("num_tpus")\n'
                  '    if num_tpus is None and merged.get("num_gpus") is not None:\n'
                  '        num_tpus = merged["num_gpus"]\n'),
             port=""),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref='        num_tpus=num_tpus,\n',
             port='        num_gpus=merged.get("num_gpus"),\n'),
        Hunk('cluster mode is not in this slice: the DAG API (.bind) raises NotImplementedError',
             ref=('        from ..dag.dag_node import FunctionNode\n'
                  '\n'
                  '        return FunctionNode(self, args, kwargs)\n'),
             port=('        raise NotImplementedError(\n'
                   '            "the DAG API is not ported yet "\n'
                   '            "(ROADMAP queue A item 4, cluster sub-slice)")\n')),
        Hunk('cluster mode is not in this slice: the DAG API (.bind) raises NotImplementedError',
             ref=('        from ..dag.dag_node import FunctionNode\n'
                  '\n'
                  '        return FunctionNode(self._remote_fn, args, kwargs, self._overrides)\n'),
             port=('        raise NotImplementedError(\n'
                   '            "the DAG API is not ported yet "\n'
                   '            "(ROADMAP queue A item 4, cluster sub-slice)")\n')),
    ],
    "core/runtime.py": [
        Hunk("docstring or comment: the reference's TPU/jax statement is false for the port",
             ref=('Architecture note (TPU-first): the runtime is deliberately\n'
                  'single-controller per process.  Distributed execution attaches node\n'
                  'backends (ray_tpu.core.node, cluster mode) underneath the same submission\n'
                  "API; SPMD compute *inside* a task is jax's job (pjit over a Mesh), not\n"
                  "the runtime's — the runtime orchestrates processes and objects, XLA\n"
                  'orchestrates chips.\n'),
             port=('Architecture note: the runtime is deliberately single-controller per\n'
                   'process.  Distributed execution attaches node backends (cluster mode)\n'
                   "underneath the same submission API; compute *inside* a task is torch's\n"
                   "and the port's CUDA kernels' job, not the runtime's — the runtime\n"
                   'orchestrates processes and objects, and schedules the card as the\n'
                   '``GPU`` resource.\n')),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref=('    def __init__(self, *, num_cpus: Optional[float] = None,\n'
                  '                 num_tpus: Optional[float] = None,\n'
                  '                 resources: Optional[Dict[str, float]] = None,\n'),
             port=('    def __init__(self, *, num_cpus: Optional[float] = None,\n'
                   '                 num_gpus: Optional[float] = None,\n'
                   '                 resources: Optional[Dict[str, float]] = None,\n')),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref='            detect_node_resources(num_cpus, num_tpus, resources))\n',
             port='            detect_node_resources(num_cpus, num_gpus, resources))\n'),
        Hunk("docstring or comment: the reference's TPU/jax statement is false for the port",
             ref=('        # thread that idles until this process imports jax, then ships\n'
                  '        # HBM gauges + XLA compile events on the EventShipper rails.\n'),
             port=('        # thread that idles until this process initialises CUDA, then\n'
                   '        # sets the device-memory gauges.\n')),
        Hunk('cluster mode is not in this slice: isolate=True raises NotImplementedError',
             ref=('        if self._isolated_pool is None:\n'
                  '            from .isolated_pool import IsolatedPool\n'
                  '\n'
                  '            with self._isolated_pool_lock:\n'
                  '                if self._isolated_pool is None:\n'
                  '                    # The OOM monitor measures the PHYSICAL box, not\n'
                  '                    # the (user-overridable) logical memory resource.\n'
                  '                    self._isolated_pool = IsolatedPool()\n'
                  '        return self._isolated_pool\n'),
             port=('        raise NotImplementedError(\n'
                   '            "isolate=True is not ported yet "\n'
                   '            "(ROADMAP queue A item 4, cluster sub-slice)")\n')),
        Hunk('cluster mode is not in this slice: the cluster attachment raises NotImplementedError',
             ref=('        from ..cluster.client import ClusterClient\n'
                  '\n'
                  '        self.cluster = ClusterClient(self, head_address,\n'
                  '                                     node_name=node_name, labels=labels)\n'
                  '        return self.cluster\n'),
             port=('        raise NotImplementedError(\n'
                   '            "cluster mode is not ported yet "\n'
                   '            "(ROADMAP queue A item 4, cluster sub-slice)")\n')),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref='                     num_tpus: Optional[float] = None,\n',
             port='                     num_gpus: Optional[float] = None,\n'),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref=('        if num_tpus:\n'
                  '            demand["TPU"] = float(num_tpus)\n'),
             port=('        if num_gpus:\n'
                   '            demand["GPU"] = float(num_gpus)\n')),
        Hunk("the message names the port's package (rewrapped)",
             ref='            "ray_tpu has not been initialized — call ray_tpu.init() first")\n',
             port=('            "ray_tpu_torch has not been initialized — call "\n'
                   '            "ray_tpu.init() first")\n')),
    ],
    "cluster/__init__.py": [],
    "cluster/rpc.py": [],
    "native/__init__.py": [
        Hunk("docstring or comment: the reference's TPU/jax statement is false for the port",
             ref='The compute path is jax/XLA/pallas; the runtime around it uses C++\n',
             port='The compute path is torch and CUDA; the runtime around it uses C++\n'),
    ],
    "native/channel.py": [],
    "native/channel.cc": [],
    "experimental/__init__.py": [],
    "experimental/channel.py": [
        Hunk("docstring or comment: the reference's TPU/jax statement is false for the port",
             ref='  array table), so numpy / jax leaves move as raw bytes and rebuild\n',
             port='  array table), so numpy / tensor leaves move as raw bytes and rebuild\n'),
    ],
    "util/__init__.py": [],
    "util/placement_group.py": [],
    "util/actor_pool.py": [],
    "util/broadcast.py": [
        Hunk("docstring or comment: the reference's TPU/jax statement is false for the port",
             ref=('Device arrays ride the same path natively: ``jax.Array`` leaves export\n'
                  'zero-copy (dlpack) into the wire layout with a header-only metadata\n'
                  'frame (dtype incl. bfloat16, shape, sharding), and each recipient\n'
                  'rebuilds with ``device_put`` straight from its staging buffer — so\n'
                  'weight distribution (model shards, optimizer state) costs one\n'),
             port=('Device arrays ride the same path natively: ``torch.Tensor`` leaves\n'
                   'export their raw bytes into the wire layout with a header-only metadata\n'
                   'frame (dtype incl. bfloat16 and float8, shape, device), and each\n'
                   'recipient rebuilds the tensor on that device from its staging buffer —\n'
                   'so weight distribution (model shards, optimizer state) costs one\n')),
    ],
    "util/queue.py": [],
    "serve/batching.py": [],
    "serve/multiplex.py": [],
    "serve/handle.py": [],
    "serve/replica.py": [],
    "serve/controller.py": [
        Hunk('the one exclusive accelerator of the comment is the GPU',
             ref='TPU), queue-depth autoscaling between min/max replicas, lightweight\n',
             port='GPU), queue-depth autoscaling between min/max replicas, lightweight\n'),
        Hunk("comment: the JAX package's change-history reference dropped (the port has its own history)",
             ref='        # Controller recovery (PR 8): deployment specs checkpoint to\n',
             port='        # Controller recovery: deployment specs checkpoint to\n'),
        Hunk('the one exclusive accelerator of the comment is the GPU',
             ref='            # Replicas hold exclusive hardware (e.g. THE TPU): a\n',
             port='            # Replicas hold exclusive hardware (e.g. THE GPU): a\n'),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref='        if opts.get("num_tpus"):\n',
             port='        if opts.get("num_gpus"):\n'),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref='        return bool((opts.get("resources") or {}).get("TPU"))\n',
             port='        return bool((opts.get("resources") or {}).get("GPU"))\n'),
    ],
    "serve/http_proxy.py": [],
    "serve/grpc_proxy.py": [],
    "serve/__init__.py": [
        Hunk("docstring or comment: the reference's TPU/jax statement is false for the port",
             ref='``ray_tpu.serve.llm`` adds a continuous-batched TPU decode deployment.\n',
             port=('``ray_tpu.serve.llm`` adds a continuous-batched decode deployment\n'
                   'on the GPU.\n')),
    ],
    "__init__.py": [
        Hunk("the port's package docstring (title)",
             ref='"""ray_tpu: a TPU-native distributed AI framework.\n',
             port='"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.\n'),
        Hunk("the port's package docstring (surface and layout)",
             ref=('Ray-equivalent capabilities (see SURVEY.md for the reference blueprint),\n'
                  'built TPU-first: tasks/actors/objects orchestrate *processes and hosts*;\n'
                  'jax/XLA (pjit over device meshes, Pallas kernels, ICI/DCN collectives)\n'
                  'owns the chip-level compute.  Public surface mirrors python/ray/__init__.py:\n'
                  '``init/shutdown/remote/get/put/wait/cancel/kill`` plus the libraries\n'
                  '(``ray_tpu.data``, ``.train``, ``.tune``, ``.serve``; an RLlib\n'
                  'equivalent is not built yet).\n'),
             port=('The port is a package of its own beside ``ray_tpu``: it imports\n'
                   '``torch``, numpy and the standard library only, never ``jax`` and\n'
                   'nothing of ``ray_tpu``.  Where it needs a module of the JAX package that\n'
                   'is framework-agnostic Python it keeps its own copy\n'
                   '(``tests/test_torch_copies.py`` holds each copy to its original).\n'
                   '\n'
                   "Public surface, as the reference's (python/ray/__init__.py):\n"
                   '``init/shutdown/remote/get/put/wait/cancel/kill`` on the local-mode\n'
                   'runtime, with the GPU as the scheduled accelerator resource\n'
                   '(``num_gpus``, ``"GPU"``), plus ``serve``.  Cluster mode\n'
                   '(``init(address=...)``, ``isolate=True``, the DAG API, ``timeline()``)\n'
                   'is not ported yet and raises ``NotImplementedError``.\n'
                   '\n'
                   'Layout mirrors the JAX package so counterparts are easy to find:\n'
                   '\n'
                   '- ``core/`` — the local runtime: tasks, actors, object store,\n'
                   '  scheduler, resources (``core/resources.py`` counts the CUDA devices)\n'
                   '- ``cluster/serialization.py`` — the object boundary; ``torch.Tensor``\n'
                   '  leaves are cloned on their own device at seal and on every read, and\n'
                   '  cross the wire as raw bytes with their dtype and device\n'
                   '- ``observability/`` — metrics, tracing, logs; ``device.py`` is the\n'
                   '  device plane on ``torch.cuda`` (memory gauges, kernel-library\n'
                   '  builds, ``torch.profiler`` traces)\n'
                   '- ``serve/`` — controller, replicas, handles, HTTP/gRPC ingress;\n'
                   '  ``serve/llm.py`` the continuous-batching ``LLMServer`` (dense and\n'
                   '  paged KV planes, int8/fp8 KV blocks, speculative decoding) and\n'
                   '  ``serve/kv_cache.py`` its block allocator and prefix cache\n'
                   '- ``models/llama.py``, ``models/moe.py`` — the model families;\n'
                   '  ``models/convert.py`` JAX (numpy) pytree <-> torch tensors\n'
                   '- ``ops/flash_attention.py`` + ``ops/csrc/`` — the flash-attention\n'
                   '  kernels for sm_90a, their plain PyTorch versions, and the wrappers\n'
                   '- ``parallel/``, ``train/`` — meshes, sharding, pipeline stages, the\n'
                   '  train step\n'
                   "- ``tools/kernel_ab.py`` — times the kernels against another checkout's\n"
                   '\n'
                   'Entry points run on ``cuda`` unless the caller passes ``device="cpu"``\n'
                   '(``core/device.py``).  Importing the package creates no CUDA context.\n')),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref='         num_tpus: Optional[float] = None,\n',
             port='         num_gpus: Optional[float] = None,\n'),
        Hunk("the message names the port's package (rewrapped)",
             ref=('            "ray_tpu.init() called twice — pass ignore_reinit_error=True "\n'
                  '            "to allow")\n'),
             port=('            "ray_tpu.init() called twice — pass "\n'
                   '            "ignore_reinit_error=True to allow")\n')),
        Hunk('cluster mode is not in this slice: init(address=...) raises NotImplementedError',
             ref=('        from .core.node import connect_to_cluster\n'
                  '\n'
                  '        return connect_to_cluster(address, namespace=namespace or "",\n'
                  '                                  runtime_env=runtime_env,\n'
                  '                                  num_cpus=num_cpus, num_tpus=num_tpus,\n'
                  '                                  resources=resources)\n'),
             port=('        raise NotImplementedError(\n'
                   '            f"init(address={address!r}): cluster mode is not ported yet "\n'
                   '            "(ROADMAP queue A item 4, cluster sub-slice)")\n')),
        Hunk('GPU: the port schedules the card as Ray\'s "GPU" resource (num_gpus)',
             ref='        num_cpus=num_cpus, num_tpus=num_tpus, resources=resources,\n',
             port='        num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,\n'),
        Hunk('cluster mode is not in this slice: timeline() raises NotImplementedError',
             ref=('    from .observability.events import export_cluster_timeline\n'
                  '\n'
                  '    return export_cluster_timeline(filename)\n'),
             port=('    raise NotImplementedError(\n'
                   '        "timeline() is not ported yet "\n'
                   '        "(ROADMAP queue A item 4, cluster sub-slice)")\n')),
    ],
}

REWRITTEN = {
    "core/__init__.py": "the port's own package docstring",
    "core/resources.py": "GPU detection through torch.cuda.device_count",
    "cluster/serialization.py": "torch.Tensor leaves in place of jax.Array "
                                "leaves: cloned per seal and per read, raw "
                                "bytes with dtype and device on the wire",
    "observability/device.py": "the device plane on torch.cuda",
    "models/__init__.py": "the port's model family",
    "models/llama.py": "the port's model family",
    "models/llama_pipeline.py": "the port's model family",
    "models/moe.py": "the port's model family",
    "ops/__init__.py": "the port's kernels",
    "ops/flash_attention.py": "the port's kernels",
    "ops/ring_attention.py": "the port's kernels",
    "parallel/__init__.py": "the port's parallel layer on torch.distributed",
    "parallel/mesh.py": "the port's parallel layer on torch.distributed",
    "parallel/pipeline.py": "the port's parallel layer on torch.distributed",
    "parallel/sharding.py": "the port's parallel layer on torch.distributed",
    "serve/kv_cache.py": "the paged plane's allocator on torch tensors",
    "serve/llm.py": "the port's serving engine",
    "tools/__init__.py": "the port's tools",
    "train/__init__.py": "the port's train step",
    "train/optim.py": "the port's train step",
}


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_matches_its_original(rel):
    expect = (REF / rel).read_text()
    for hunk in COPIES[rel]:
        assert hunk.reason, f"{rel}: a hunk without a reason"
        n = expect.count(hunk.ref)
        assert n == 1, f"{rel}: hunk ({hunk.reason}) found {n} times"
        expect = expect.replace(hunk.ref, normalise(hunk.port))
    got = normalise((PORT / rel).read_text())
    if got != expect:
        diff = "".join(difflib.unified_diff(
            expect.splitlines(keepends=True), got.splitlines(keepends=True),
            f"ray_tpu/{rel} + listed hunks", f"ray_tpu_torch/{rel}"))
        pytest.fail(f"{rel} differs from its original beyond its listed "
                    f"hunks:\n{diff}")


def test_every_file_with_an_original_is_listed():
    port_files = {p.relative_to(PORT).as_posix()
                  for p in PORT.rglob("*")
                  if p.suffix in (".py", ".cc") and "_build" not in p.parts}
    with_original = {rel for rel in port_files if (REF / rel).exists()}
    unlisted = with_original - set(COPIES) - set(REWRITTEN)
    assert not unlisted, f"not listed as copy or rewrite: {sorted(unlisted)}"
    assert not set(COPIES) & set(REWRITTEN)
    assert set(COPIES) <= port_files and set(REWRITTEN) <= port_files
