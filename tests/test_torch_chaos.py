"""Twin of ``tests/test_chaos.py`` for the port: the fault-injection
schedules of ``ray_tpu_torch.experimental.chaos`` driving the port's
recovery paths on the CPU (the runtime's fixtures advertise no GPU).

- The schedule API over the port's RPC layer; a seeded probabilistic
  drop list is the same list in both packages.
- The compiled DAG's rings (``dag{p}-{c}``): a killed producer raises
  ``ActorDiedError`` within twice the read deadline, a restarted one is
  replanned, a severed ring fails the pass fast and heals.
- The pipeline trainer rewritten for torch (``train/cross_pipeline.py``,
  rings ``pp-fwd{i}``) at ``LlamaConfig.debug(tie_embeddings=False)`` in
  f32.  Where the reference skips when no boundary ring is planned, the
  twin fails.  The severed step is also held by its numbers: the three
  losses of the severed run equal those of an unsevered run from the
  same seed and batches (rtol 1e-6).
- Error context, the native peer-death probe, the Serve handle's retry
  onto a live replica and the broadcast tree's severed hop.

Every test keeps the reference's deadlines, seeds and sizes.
"""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_runtime import ray_start_regular, shutdown_only  # noqa: F401
from ray_tpu_torch.exceptions import ActorDiedError, ChannelError
from ray_tpu_torch.experimental import chaos

pytestmark = pytest.mark.chaos


def _channels_or_skip():
    from ray_tpu_torch.experimental.channel import channels_available

    if not channels_available():
        pytest.skip("native channel lib unavailable")


def _drop_list(chaos_mod, n=40):
    """Which of ``n`` calls a seeded probabilistic drop rule fails."""
    sched = chaos_mod.schedule(seed=3).drop_rpc("echo", count=n, prob=0.5)
    out = []
    for _ in range(n):
        try:
            sched.rpc_hook("echo")
            out.append(False)
        except ConnectionError:
            out.append(True)
    return out


# ---------------------------------------------------------------------------
# The schedule API itself
# ---------------------------------------------------------------------------

class TestScheduleApi:
    def test_rpc_drop_schedule_is_deterministic_and_queryable(self):
        from ray_tpu_torch.cluster.rpc import RpcClient, RpcServer

        server = RpcServer({"echo": lambda p: p})
        client = RpcClient(server.address)
        try:
            sched = chaos.schedule(seed=3).drop_rpc("echo", count=2)
            with sched:
                with pytest.raises(ConnectionError):
                    client.call("echo", 1)
                with pytest.raises(ConnectionError):
                    client.call("echo", 2)
                assert client.call("echo", 3) == 3
            # Out of scope: no more injection.
            assert client.call("echo", 4) == 4
            assert sched.fired("rpc_drop", "echo") == 2
            assert [e["method"] for e in sched.events()] == \
                ["echo", "echo"]
        finally:
            client.close()
            server.shutdown()
        # The seeded draws: the same seed drops the same calls in both
        # packages, and some but not all of them.
        from ray_tpu.experimental import chaos as ref_chaos

        drops = _drop_list(chaos)
        assert drops == _drop_list(ref_chaos)
        assert 0 < sum(drops) < len(drops)

    def test_retrying_call_rides_out_injected_drops(self):
        from ray_tpu_torch.cluster.rpc import ReconnectingClient, RpcServer

        applied = []
        server = RpcServer({"mutate": lambda p: applied.append(p) or
                            {"ok": True, "n": len(applied)}})
        client = ReconnectingClient(server.address)
        try:
            with chaos.schedule().drop_rpc("mutate", count=3):
                resp = client.call_idempotent(
                    "mutate", {"v": 1}, deadline_s=20.0)
            assert resp["ok"]
            assert len(applied) == 1  # retries did not double-apply
        finally:
            client.close()
            server.shutdown()

    def test_env_var_knob_still_honored(self, monkeypatch):
        """The RAY_TPU_TESTING_RPC_FAILURE parser is wrapped, not broken
        (subprocess workers inherit faults through env)."""
        from ray_tpu_torch.cluster.rpc import RpcClient, RpcServer

        monkeypatch.setenv("RAY_TPU_TESTING_RPC_FAILURE", "echo=1")
        server = RpcServer({"echo": lambda p: p})
        client = RpcClient(server.address)
        try:
            with pytest.raises(ConnectionError):
                client.call("echo", 1)
            assert client.call("echo", 2) == 2
        finally:
            client.close()
            server.shutdown()


# ---------------------------------------------------------------------------
# Idempotent control plane
# ---------------------------------------------------------------------------

class TestIdempotentHead:
    def test_duplicate_register_actor_replays_first_reply(self):
        """A retried register_actor whose first RESPONSE was lost must
        not double-apply (here: must not trip the name-taken check)."""
        from ray_tpu_torch.cluster.head import HeadServer
        from ray_tpu_torch.cluster.rpc import ReconnectingClient

        head = HeadServer("127.0.0.1", 0)
        client = ReconnectingClient(head.address)
        try:
            payload = {"actor_id": b"a" * 16, "node_id": "n1",
                       "address": "127.0.0.1:1", "name": "singleton",
                       "_idem": "key-1"}
            r1 = client.call("register_actor", dict(payload))
            r2 = client.call("register_actor", dict(payload))
            assert r1["ok"] and r2["ok"]  # duplicate key: cached reply
            # A DIFFERENT logical call hits the real handler and the
            # name conflict fires — the dedup is key-scoped.
            other = {**payload, "actor_id": b"b" * 16, "_idem": "key-2"}
            assert not client.call("register_actor", other)["ok"]
        finally:
            client.close()
            head.shutdown()


# ---------------------------------------------------------------------------
# Compiled-DAG recovery
# ---------------------------------------------------------------------------

class TestCompiledDagChaos:
    def _three_stage_dag(self, channel_timeout, producer_opts=None):
        from ray_tpu_torch.dag import InputNode

        @ray_tpu_torch.remote
        class Stage:
            def step(self, x):
                return x + 1

        with InputNode() as inp:
            a = (Stage.options(**producer_opts) if producer_opts
                 else Stage).bind()
            b = Stage.bind()
            c = Stage.bind()
            dag = c.step.bind(b.step.bind(a.step.bind(inp)))
        return dag.experimental_compile(channel_timeout=channel_timeout)

    def test_producer_killed_mid_pass_raises_typed_within_deadline(
            self, ray_start_regular):
        """A producer hard-killed mid-pass (no error frame flushed): the
        driver sees a typed ActorDiedError within 2x the read deadline,
        not a wedged reader."""
        _channels_or_skip()
        deadline = 2.0
        compiled = self._three_stage_dag(channel_timeout=deadline)
        assert compiled._channel_edges  # rings actually planned
        assert ray_tpu_torch.get(compiled.execute(0)) == 3

        sched = chaos.schedule().kill_at_ring_write("dag0-1", nth=2)
        with sched:
            t0 = time.monotonic()
            with pytest.raises(ActorDiedError):
                ray_tpu_torch.get(compiled.execute(0),
                                  timeout=4 * deadline)
            elapsed = time.monotonic() - t0
        assert sched.fired("ring_kill") == 1
        assert elapsed < 2 * deadline, \
            f"typed error took {elapsed:.1f}s (> 2x{deadline}s deadline)"
        compiled.teardown()

    def test_restart_and_replan_next_pass_succeeds(
            self, ray_start_regular):
        """A producer with max_restarts=1 killed mid-DAG: the in-flight
        pass fails typed, and a later pass succeeds on rings rebuilt
        against the restarted actor."""
        _channels_or_skip()
        compiled = self._three_stage_dag(
            channel_timeout=2.0, producer_opts={"max_restarts": 1})
        assert compiled._channel_edges
        assert ray_tpu_torch.get(compiled.execute(0)) == 3
        old_paths = set(compiled._channel_edges.values())

        with chaos.schedule().kill_at_ring_write(
                "dag0-1", nth=2, no_restart=False):
            with pytest.raises((ActorDiedError, ChannelError)):
                ray_tpu_torch.get(compiled.execute(0), timeout=10.0)

        deadline = time.monotonic() + 30.0
        while True:
            try:
                assert ray_tpu_torch.get(compiled.execute(0),
                                         timeout=10.0) == 3
                break
            except (ActorDiedError, ChannelError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        new_paths = set(compiled._channel_edges.values())
        assert new_paths and new_paths != old_paths, \
            "expected rebuilt rings after the restart"
        assert ray_tpu_torch.get(compiled.execute(5), timeout=10.0) == 8
        compiled.teardown()

    def test_severed_ring_fails_pass_fast_not_wedged(
            self, ray_start_regular):
        """Severing a ring mid-frame fails the pass with a typed error
        well inside the deadline, and the DAG heals for the next pass."""
        _channels_or_skip()
        deadline = 5.0
        compiled = self._three_stage_dag(channel_timeout=deadline)
        assert ray_tpu_torch.get(compiled.execute(0)) == 3

        sched = chaos.schedule().sever_ring("dag1-2", at_frame=2)
        with sched:
            t0 = time.monotonic()
            with pytest.raises((ChannelError, ActorDiedError)):
                ray_tpu_torch.get(compiled.execute(0),
                                  timeout=4 * deadline)
            assert time.monotonic() - t0 < 2 * deadline
        assert sched.fired("ring_sever") == 1
        t_end = time.monotonic() + 30.0
        while True:
            try:
                assert ray_tpu_torch.get(compiled.execute(0),
                                         timeout=10.0) == 3
                break
            except (ChannelError, ActorDiedError):
                if time.monotonic() > t_end:
                    raise
                time.sleep(0.2)
        compiled.teardown()

    def test_soak_seeded_schedule_no_hangs(self, ray_start_regular):
        """A seeded kill/sever schedule over repeated passes of a
        3-actor DAG: every pass completes or raises a typed error within
        its deadline, and the DAG keeps recovering."""
        _channels_or_skip()
        deadline = 2.0
        compiled = self._three_stage_dag(
            channel_timeout=deadline, producer_opts={"max_restarts": -1})
        assert ray_tpu_torch.get(compiled.execute(0)) == 3

        sched = (chaos.schedule(seed=11)
                 .kill_at_ring_write("dag0-1", nth=3, no_restart=False)
                 .sever_ring("dag1-2", at_frame=6))
        completed, typed_errors = 0, 0
        with sched:
            for i in range(12):
                t0 = time.monotonic()
                try:
                    assert ray_tpu_torch.get(compiled.execute(i),
                                             timeout=4 * deadline) == i + 3
                    completed += 1
                except (ActorDiedError, ChannelError):
                    typed_errors += 1
                    assert time.monotonic() - t0 < 3 * deadline
                time.sleep(0.05)
        assert completed >= 6, f"only {completed} passes completed"
        assert typed_errors >= 1, "schedule never fired"
        assert sched.events(), "no chaos events recorded"
        compiled.teardown()


# ---------------------------------------------------------------------------
# Cross-pipeline recovery
# ---------------------------------------------------------------------------

def _debug_pipe():
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.cross_pipeline import CrossSlicePipeline

    cfg = llama.LlamaConfig.debug(tie_embeddings=False,
                                  dtype=torch.float32)
    pipe = CrossSlicePipeline(cfg, n_stages=2, num_microbatches=2,
                              device="cpu")
    assert any(pipe._fwd_ch), "no same-host boundary ring planned"
    return cfg, pipe


class TestPipelineChaos:
    def test_two_stage_pipeline_survives_severed_boundary(
            self, ray_start_regular):
        """A 2-stage GPipe step whose boundary ring is severed mid-wave
        recovers within the step (reset + replan + retry): training
        goes on with rebuilt rings, and its losses are those of an
        unsevered run from the same seed and batches."""
        _channels_or_skip()
        from ray_tpu_torch.models import llama

        vocab = llama.LlamaConfig.debug().vocab_size
        rng = np.random.default_rng(0)
        batches = [rng.integers(0, vocab, (4, 16))
                   .astype(np.int32) for _ in range(3)]

        _, clean = _debug_pipe()
        try:
            want = [clean.train_step(b)["loss"] for b in batches]
        finally:
            clean.shutdown()

        _, pipe = _debug_pipe()
        try:
            old_ring = pipe._fwd_ch[0]
            m0 = pipe.train_step(batches[0])
            assert np.isfinite(m0["loss"])

            sched = chaos.schedule().sever_ring("pp-fwd0", at_frame=3)
            with sched:
                m1 = pipe.train_step(batches[1])
            assert sched.fired("ring_sever") == 1
            assert np.isfinite(m1["loss"])
            assert pipe._fwd_ch[0] != old_ring, \
                "expected the severed boundary ring to be rebuilt"
            m2 = pipe.train_step(batches[2])
            assert np.isfinite(m2["loss"])
        finally:
            pipe.shutdown()
        got = [m0["loss"], m1["loss"], m2["loss"]]
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_stage_killed_mid_step_raises_typed_not_hang(
            self, ray_start_regular):
        """A stage hard-killed mid-wave (no restart budget): the step
        raises a typed error within its deadline instead of hanging; the
        error context names the edge."""
        _channels_or_skip()
        cfg, pipe = _debug_pipe()
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, (4, 16)) \
            .astype(np.int32)
        try:
            assert np.isfinite(pipe.train_step(tokens)["loss"])
            with chaos.schedule().kill_at_ring_write("pp-fwd0", nth=3):
                with pytest.raises((ActorDiedError, ChannelError)):
                    pipe.train_step(tokens)
        finally:
            pipe.shutdown()


    def test_killed_stage_error_names_the_edge(self, ray_start_regular):
        """Fault C16: a stage killed mid-step failed the step with the
        dead stage's bare "actor is dead" (the wave's last calls), which
        names no edge.  The step now raises the error of the wave's first
        failed call: the ring it broke on and the method."""
        _channels_or_skip()
        cfg, pipe = _debug_pipe()
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32)
        try:
            pipe.train_step(tokens)
            with chaos.schedule().kill_at_ring_write("pp-fwd0", nth=3):
                with pytest.raises((ActorDiedError, ChannelError)) as ei:
                    pipe.train_step(tokens)
        finally:
            pipe.shutdown()
        assert "pp-fwd0" in str(ei.value), str(ei.value)
        assert "method=forward" in str(ei.value), str(ei.value)

    def test_killed_stage_error_names_the_edge_when_its_call_settles_last(
            self, ray_start_regular, monkeypatch):
        """Fault C18: the choice of the wave's first failed call probed
        each ref once and passed over those still running, so under load,
        when the call that broke on ``pp-fwd0`` had not yet stored its
        error as the step raised, a later call's bare "actor is dead" was
        raised.  Here that call reports "not ready" for 0.2 s after it
        first shows finished, every time (a wait with a longer timeout
        sleeps until then, as the real one would): the step must still
        name the edge."""
        _channels_or_skip()
        cfg, pipe = _debug_pipe()
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32)
        real_wait = ray_tpu_torch.wait
        hold_s = 0.2
        released_at = {}

        def breaks_on_the_edge(ref):
            try:
                ray_tpu_torch.get(ref)
            except (ActorDiedError, ChannelError) as e:
                return "pp-fwd0" in str(e) and "method=forward" in str(e)
            return False

        def late_wait(refs, *, timeout=None, **kw):
            t_in = time.monotonic()
            ready, rest = real_wait(refs, timeout=timeout, **kw)
            late = []
            for r in ready:
                if r not in released_at and breaks_on_the_edge(r):
                    released_at[r] = time.monotonic() + hold_s
                if r in released_at and time.monotonic() < released_at[r]:
                    late.append(r)
            if late:
                until = max(released_at[r] for r in late)
                if timeout is not None:
                    until = min(until, t_in + timeout)
                time.sleep(max(0.0, until - time.monotonic()))
                late = [r for r in late
                        if time.monotonic() < released_at[r]]
            return ([r for r in ready if r not in late],
                    list(rest) + late)

        try:
            pipe.train_step(tokens)
            monkeypatch.setattr(ray_tpu_torch, "wait", late_wait)
            with chaos.schedule().kill_at_ring_write("pp-fwd0", nth=3):
                with pytest.raises((ActorDiedError, ChannelError)) as ei:
                    pipe.train_step(tokens)
        finally:
            monkeypatch.undo()
            pipe.shutdown()
        assert "pp-fwd0" in str(ei.value), str(ei.value)
        assert "method=forward" in str(ei.value), str(ei.value)
        assert released_at, "the call that broke on pp-fwd0 was not held"

    def test_killed_stage_releases_its_instance(self, ray_start_regular,
                                                monkeypatch):
        """Fault C14: a failed call's stored error kept the frames it was
        raised through, and they kept the killed stage's instance (the
        channel step's closure, the runtime's own frame), with its model
        and optimizer state, as long as the error's refs lived.  After
        ``shutdown()`` both stages are collected, while the driver still
        holds the step's error."""
        _channels_or_skip()
        import gc
        import weakref

        from ray_tpu_torch.train import cross_pipeline

        alive = []
        klass = cross_pipeline._StageWorker._klass
        init = klass.__init__

        def tracked(self, *a, **k):
            init(self, *a, **k)
            alive.append(weakref.ref(self))

        monkeypatch.setattr(klass, "__init__", tracked)
        cfg, pipe = _debug_pipe()
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32)
        try:
            pipe.train_step(tokens)
            with chaos.schedule().kill_at_ring_write("pp-fwd0", nth=3):
                with pytest.raises((ActorDiedError, ChannelError)) as ei:
                    pipe.train_step(tokens)
        finally:
            pipe.shutdown()
        assert len(alive) == 2
        deadline = time.monotonic() + 10.0
        while any(r() is not None for r in alive):
            assert time.monotonic() < deadline, \
                f"{sum(r() is not None for r in alive)} stages still held"
            gc.collect()
            time.sleep(0.1)
        assert ei.value is not None


# ---------------------------------------------------------------------------
# Structured error context
# ---------------------------------------------------------------------------

class TestErrorContext:
    def test_actor_died_error_carries_and_pickles_context(self):
        import pickle

        err = ActorDiedError(None, "producer died mid-pass",
                             node_id="deadbeef" * 4,
                             context={"ring": "dag0-1", "frame_seq": 7})
        assert "ring=dag0-1" in str(err)
        assert "frame_seq=7" in str(err)
        back = pickle.loads(pickle.dumps(err))
        assert back.context["frame_seq"] == 7
        assert back.node_id == err.node_id

    def test_channel_error_frames_carry_edge_context(
            self, ray_start_regular):
        """A producer exception crosses the ring as an error frame whose
        context names the originating edge (ring, actor, frame), surfaced
        in the driver-side message."""
        _channels_or_skip()
        from ray_tpu_torch.dag import InputNode

        @ray_tpu_torch.remote
        class P:
            def boom(self, x):
                raise RuntimeError("producer exploded")

        @ray_tpu_torch.remote
        class C:
            def use(self, v):
                return v

        with InputNode() as inp:
            dag = C.bind().use.bind(P.bind().boom.bind(inp))
        compiled = dag.experimental_compile(channel_timeout=10.0)
        assert compiled._channel_edges
        with pytest.raises(ChannelError) as ei:
            ray_tpu_torch.get(compiled.execute(1))
        msg = str(ei.value)
        assert "producer exploded" in msg
        assert "ring=" in msg and "method=boom" in msg
        assert ei.value.context.get("frame_seq") is not None
        compiled.teardown()

    def test_peer_process_death_detected_on_read_path(self, tmp_path):
        """The native pid probe on the read path: a writer process dying
        mid-stream surfaces as ChannelPeerDied in about one probe slice,
        not a full timeout."""
        import subprocess
        import sys

        from ray_tpu_torch.native.channel import Channel, ChannelPeerDied

        _channels_or_skip()
        path = str(tmp_path / "ring")
        Channel.create(path, n_slots=4, slot_bytes=4096)
        code = ("from ray_tpu_torch.native.channel import Channel; "
                "import os;"
                f"c = Channel({path!r}, writer=True);"
                "c.put(b'one'); os._exit(9)")
        subprocess.run([sys.executable, "-c", code], check=False)
        reader = Channel(path, writer=False)
        try:
            assert reader.get(timeout=5.0) == b"one"  # drained first
            t0 = time.monotonic()
            with pytest.raises(ChannelPeerDied):
                reader.get(timeout=30.0)
            assert time.monotonic() - t0 < 2.0
        finally:
            reader.destroy()


# ---------------------------------------------------------------------------
# Serve handle failover
# ---------------------------------------------------------------------------

class TestServeHandleFailover:
    def test_handle_retries_onto_live_replica(self, shutdown_only):
        """ActorDiedError from a stopped replica re-resolves routing and
        lands on a live one instead of surfacing to the caller."""
        ray_tpu_torch.init(num_cpus=8, num_gpus=0)
        from ray_tpu_torch import serve

        @serve.deployment(num_replicas=2)
        class Echo:
            def __call__(self, x):
                return ("ok", id(self), x)

        handle = serve.run(Echo.bind())
        try:
            assert handle.remote(1).result(timeout=30)[0] == "ok"
            controller = serve._get_controller(create=False)
            replicas = ray_tpu_torch.get(
                controller.get_replicas.remote("Echo"), timeout=10)
            ray_tpu_torch.kill(replicas[0])
            time.sleep(0.2)
            # Enough calls that the router MUST hit the dead slot at
            # least once without failover.
            for i in range(8):
                assert handle.remote(i).result(timeout=30)[0] == "ok"
        finally:
            serve.shutdown()


    def test_killed_replica_engine_is_freed(self, shutdown_only):
        """Fault C15: an LLMServer's scheduler thread held its engine, so
        a killed replica's engine (the actor let go of its instance) went
        on running and kept its weights and KV cache.  After the kill
        the handle answers every request from the live replica, and the
        killed replica's engine is collected and its thread ends."""
        import gc
        import weakref

        ray_tpu_torch.init(num_cpus=8, num_gpus=0)
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.llm import LLMServer

        engines = []

        class Tracked(LLMServer):
            def __init__(self, **kw):
                super().__init__(**kw)
                engines.append((weakref.ref(self), self._thread))

        engine = dict(model_preset="debug", max_slots=2, max_len=64,
                      prefill_buckets=(16,), decode_chunk=8,
                      prefill_groups=(2,), device="cpu")
        handle = serve.run(serve.deployment(
            Tracked, num_replicas=2, name="llm").bind(**engine))
        try:
            req = {"prompt": [1, 2, 3], "max_new_tokens": 4}
            want = handle.generate.remote(req).result(timeout=60)["tokens"]
            controller = serve._get_controller(create=False)
            replicas = ray_tpu_torch.get(
                controller.get_replicas.remote("llm"), timeout=10)
            ray_tpu_torch.kill(replicas[0])
            outs = [handle.generate.remote(req) for _ in range(8)]
            assert [o.result(timeout=60)["tokens"] for o in outs] == \
                [want] * 8
            deadline = time.monotonic() + 10.0
            while sum(r() is not None for r, _ in engines) != 1:
                assert time.monotonic() < deadline, \
                    "the killed replica's engine is still held"
                gc.collect()
                time.sleep(0.1)
            dead = [t for r, t in engines if r() is None]
            dead[0].join(timeout=10.0)
            assert not dead[0].is_alive()
        finally:
            serve.shutdown()


# ---------------------------------------------------------------------------
# Broadcast relay tree under chaos
# ---------------------------------------------------------------------------

@pytest.mark.net
class TestBroadcastRelaySever:
    def test_severed_mid_tree_hop_fails_typed_and_releases_refs(self):
        """A mid-tree relay hop severs its subtree mid-stream (env chaos
        budget on the raw push path): the source gets a typed
        ChannelError within the read deadline, holds no borrower
        registrations for the object, and a retry after the fault budget
        drains succeeds."""
        from _torch_cluster import Cluster
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        ray_tpu_torch.shutdown()
        c = Cluster()
        # n1 is the mid-tree hop: its FIRST raw relay chunk raises.
        c.add_node(num_cpus=1, name="n1", env={
            "RAY_TPU_TESTING_RPC_FAILURE": "push_raw_chunk=1"})
        c.add_node(num_cpus=1, name="n2")
        c.connect(num_cpus=1)
        try:
            # The wire path (no shm mmap shortcut) and a chain
            # topology: driver -> n1 -> n2.
            GLOBAL_CONFIG.set("object_shm_min_bytes", 0)
            GLOBAL_CONFIG.set("object_broadcast_fanout", 1)
            rt = ray_tpu_torch.get_runtime()
            nodes = {n["name"]: n["address"]
                     for n in rt.cluster.list_nodes()
                     if n.get("alive") and n["name"]}
            payload = np.zeros(12 * 1024 * 1024, dtype=np.uint8)
            ref = ray_tpu_torch.put(payload)
            oid = ref.object_id()
            t0 = time.monotonic()
            with pytest.raises(ChannelError) as ei:
                rt.cluster.broadcast_object(
                    ref, [nodes["n1"], nodes["n2"]], timeout=20.0)
            assert time.monotonic() - t0 < 20.0, "not within deadline"
            assert "subtree_root" in ei.value.context
            # Pushed copies are caches, never borrows.
            entry = rt.reference_counter._refs.get(oid)
            assert entry is None or not entry.borrowers
            n = rt.cluster.broadcast_object(
                ref, [nodes["n1"], nodes["n2"]], timeout=30.0)
            assert n == 2
        finally:
            GLOBAL_CONFIG.reset()
            ray_tpu_torch.shutdown()
            c.shutdown()
