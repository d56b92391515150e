"""The port's gang fault plane and actor collectives against the JAX
package's, on the CPU.

One module-scoped cluster of each package (``ray_tpu`` and
``ray_tpu_torch``), both with ``collective_timeout_s`` at 120 s, so every
detection below holds because of the membership push and never because a
timeout was short. The scenarios are those of
``tests/test_collective.py``, ``tests/test_gang_fault_plane.py`` and
``tests/test_elastic_restart.py``:

* ``util.collective`` across actor ranks (allreduce, allgather,
  reducescatter, broadcast small and large, barrier, send/recv) and
  ``HostCollectiveGroup``, held to numpy and to the JAX package's results;
* the generation-stamped coordinator (a stale generation refused, a lost
  member kept out, a timeout naming its missing ranks, op state collected
  on a member's death) and the gang-aware ``WorkerGroup`` (generations
  strictly monotonic across re-forms, a lost member's push beating the
  flat timeout, a formation failure leaking nothing), run on both
  packages at once in two threads with the outcomes compared;
* the trainer's typed loss ladder and ``classify_pipeline_loss`` on the
  same inputs in both packages;
* the elastic 2 -> 1 -> 2 dip and the shrink-only run through the port's
  ``TorchTrainer`` (gloo), held to the reference test's outcomes and to
  the single-process trajectory computed with JAX and optax.

Remote classes and train loops are defined inside the scenarios, so
cloudpickle ships them by value and no worker imports this module (which
imports JAX). The fixture shuts both clusters down and removes the port's
arenas and session directory, failures included.
"""

import glob
import importlib
import os
import shutil
import signal
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

TIMEOUT_S = 120.0
PKGS = {"jax": ray_tpu, "port": ray_tpu_torch}


@pytest.fixture(scope="module")
def clusters():
    base = tempfile.gettempdir()
    root = tempfile.mkdtemp(prefix="rtk", dir=base if len(base) < 48
                            else "/tmp")
    saved = os.environ.get("RAY_TPU_TORCH_TMPDIR")
    os.environ["RAY_TPU_TORCH_TMPDIR"] = root
    session = None
    for rt in PKGS.values():
        if rt.is_initialized():
            rt.shutdown()
    cfg = {"collective_timeout_s": TIMEOUT_S}
    try:
        ray_tpu.init(num_cpus=8, probe_tpu=False, ignore_reinit_error=True,
                     _system_config=cfg)
        ray_tpu_torch.init(num_cpus=8, probe_gpu=False, _system_config=cfg)
        session = ray_tpu_torch._private.worker.global_worker().session_name
        yield root
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_TORCH_TMPDIR", None)
        else:
            os.environ["RAY_TPU_TORCH_TMPDIR"] = saved
        try:
            ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            for p in glob.glob("/dev/shm/rtpt*"):
                if session and session[-8:] in p:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            shutil.rmtree(root, ignore_errors=True)


def _mod(name, path):
    return importlib.import_module(f"{PKGS[name].__name__}.{path}")


def _both(scenario, *args):
    """``scenario(name, *args)`` on both packages at once: (jax, port)."""
    with ThreadPoolExecutor(2) as pool:
        jax_f, port_f = (pool.submit(scenario, n, *args)
                         for n in ("jax", "port"))
        return jax_f.result(), port_f.result()


def _raised(fn):
    """The class name of what ``fn`` raised, and the exception."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is the result
        return type(e).__name__, e
    return None, None


# ----------------------------------------------------------- collectives


def _rank_class(name):
    rt = PKGS[name]
    pkg = rt.__name__

    @rt.remote
    class Rank:
        def __init__(self, world, rank, group):
            import importlib

            self.c = importlib.import_module(pkg + ".util.collective")
            self.c.init_collective_group(world, rank, group_name=group)
            self.rank = rank
            self.group = group

        def allreduce(self, value, op):
            return self.c.allreduce(np.full(4, value, np.float64),
                                    group_name=self.group, op=op)

        def allgather(self):
            return self.c.allgather(np.full(2, self.rank, np.int64),
                                    group_name=self.group)

        def reducescatter(self):
            return self.c.reducescatter(
                np.arange(8, dtype=np.float64) + self.rank,
                group_name=self.group)

        def broadcast(self, n):
            return self.c.broadcast(
                np.arange(n, dtype=np.float64) + self.rank * 10,
                src_rank=1, group_name=self.group)

        def barrier(self):
            self.c.barrier(group_name=self.group)
            return True

        def sendrecv(self):
            if self.rank == 0:
                self.c.send(np.array([42.0, 7.0]), dst_rank=1,
                            group_name=self.group)
                return None
            return self.c.recv(src_rank=0, group_name=self.group)

        def host_group(self, world, name):
            import importlib

            col = importlib.import_module(pkg + ".parallel.collectives")
            g = col.HostCollectiveGroup(name, world, self.rank)
            x = np.arange(3, dtype=np.float64) * (self.rank + 1)
            out = [g.allreduce(x, op=op) for op in ("sum", "mean", "max",
                                                     "min")]
            g.barrier()
            return out

    return Rank


def _collectives(name):
    rt = PKGS[name]
    Rank = _rank_class(name)
    world = 3
    ranks = [Rank.remote(world, r, "tg") for r in range(world)]

    def fan(method, *args):
        return rt.get([getattr(r, method).remote(*args) for r in ranks],
                      timeout=120)

    out = {
        "sum": fan("allreduce", 2.0, "sum"),
        "allgather": fan("allgather"),
        "reducescatter": fan("reducescatter"),
        "broadcast": fan("broadcast", 3),
        # 1 MiB and up rides the store as one shared object
        "broadcast_big": fan("broadcast", 1 << 17),
        "barrier": fan("barrier"),
        "host": fan("host_group", world, f"hg-{name}"),
    }
    pair = [Rank.remote(2, r, "p2p") for r in range(2)]
    out["sendrecv"] = rt.get([r.sendrecv.remote() for r in pair],
                             timeout=120)
    for a in ranks + pair:
        rt.kill(a)
    return out


def test_actor_collectives_match_numpy_and_jax(clusters):
    jax_out, port_out = _both(_collectives)
    for r in range(3):
        np.testing.assert_array_equal(port_out["sum"][r], np.full(4, 6.0))
        assert [p.tolist() for p in port_out["allgather"][r]] == \
            [[0, 0], [1, 1], [2, 2]]
        np.testing.assert_array_equal(port_out["broadcast"][r],
                                      np.arange(3) + 10.0)
        np.testing.assert_array_equal(port_out["broadcast_big"][r],
                                      np.arange(1 << 17) + 10.0)
        want = np.arange(3, dtype=np.float64)[None] * np.arange(1, 4)[:, None]
        for got, red in zip(port_out["host"][r],
                            (want.sum(0), want.mean(0), want.max(0),
                             want.min(0))):
            np.testing.assert_array_equal(got, red)
    np.testing.assert_array_equal(np.concatenate(port_out["reducescatter"]),
                                  3 * np.arange(8.0) + 3)
    assert port_out["barrier"] == [True] * 3
    assert port_out["sendrecv"][0] is None
    np.testing.assert_array_equal(port_out["sendrecv"][1], [42.0, 7.0])
    # the JAX package's results, leaf for leaf
    for key, want in jax_out.items():
        got = port_out[key]
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            if isinstance(w, list):
                assert len(g) == len(w), key
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b, err_msg=key)
            else:
                np.testing.assert_array_equal(g, w, err_msg=key)


def test_backends_refused_as_the_reference_refuses():
    """An unknown backend is refused by both; a device backend by the
    port with its pointer to ``parallel`` (the reference refuses "tpu",
    pointing at its compiled collectives)."""
    from ray_tpu.util import collective as jcol
    from ray_tpu_torch.util import collective as tcol

    for col in (jcol, tcol):
        with pytest.raises(ValueError, match="unknown collective backend"):
            col.init_collective_group(2, 0, backend="mpi")
        with pytest.raises(ValueError, match="outside world"):
            col.init_collective_group(2, 2)
    with pytest.raises(ValueError, match="compiled into the program"):
        jcol.init_collective_group(2, 0, backend="tpu")
    with pytest.raises(ValueError, match="torch.distributed"):
        tcol.init_collective_group(2, 0, backend="nccl")


# ------------------------------------------------------------ coordinator


def _coordinator(name):
    rt = PKGS[name]
    col = _mod(name, "util.collective")
    Coord = rt.remote(col._Coordinator)
    out = {}
    coord = Coord.remote(2, generation=3)
    out["stale"] = [_raised(lambda g=g: rt.get(coord.collect.remote(
        "barrier", 0, 0, None, generation=g), timeout=30))[0]
        for g in (2, 4)]
    rt.kill(coord)

    coord = Coord.remote(3, generation=1)
    assert rt.get(coord.member_lost.remote([2], "killed", generation=1),
                  timeout=30)
    # a loss stamped with another generation is ignored
    assert not rt.get(coord.member_lost.remote([0], "x", generation=9),
                      timeout=30)
    kind, err = _raised(lambda: rt.get(coord.collect.remote(
        "allreduce", 0, 0, np.ones(2), generation=1), timeout=30))
    out["rejoin"] = (kind, err.lost_ranks, err.generation)
    rt.kill(coord)

    coord = Coord.remote(3, timeout_s=2.0)
    kind, err = _raised(lambda: rt.get(coord.collect.remote(
        "allreduce", 0, 0, np.ones(2)), timeout=30))
    out["timeout"] = (kind, err.missing_ranks, err.kind,
                      isinstance(err, TimeoutError))
    rt.kill(coord)

    coord = Coord.remote(3, generation=1)
    ref2 = coord.collect.remote("allreduce", 0, 2, np.ones(2), generation=1)
    _, pending = rt.wait([ref2], timeout=1.0)
    out["pending_before"] = bool(pending)
    rt.get(coord.member_lost.remote([2], "killed", generation=1), timeout=30)
    out["gc"] = [
        _raised(lambda: rt.get(ref2, timeout=30))[0],
        rt.get(coord.debug_state.remote(), timeout=10)["pending_ops"],
        _raised(lambda: rt.get(coord.collect.remote(
            "allreduce", 0, 0, np.ones(2), generation=1), timeout=30))[0],
        rt.get(coord.debug_state.remote(), timeout=10)["pending_ops"]]
    rt.kill(coord)
    return out


def test_coordinator_generations_losses_and_timeouts_match(clusters):
    jax_out, port_out = _both(_coordinator)
    assert jax_out == port_out
    assert port_out == {
        "stale": ["StaleCollectiveGeneration"] * 2,
        "rejoin": ("CollectiveMemberLost", [2], 1),
        "timeout": ("CollectiveTimeout", [1, 2], "allreduce", True),
        "pending_before": True,
        "gc": ["CollectiveMemberLost", [], "CollectiveMemberLost", []],
    }


# ------------------------------------------------------------ worker group


def _form(name, n, gang, timeout=60.0):
    wg = _mod(name, "train.worker_group")
    return wg.WorkerGroup(n, {"CPU": 1.0}, gang_name=gang,
                          formation_timeout_s=timeout)


def _generations(name):
    rt = PKGS[name]
    gens = []
    g = _form(name, 3, "geninv")
    gens.append(g.generation)
    g.shutdown()
    g = _form(name, 3, "geninv")
    gens.append(g.generation)
    pid = rt.get(g.workers[1].pid.remote(), timeout=30)
    os.kill(pid, signal.SIGKILL)
    pushed = g._gang_lost.wait(timeout=30)
    g.shutdown()
    g = _form(name, 2, "geninv")
    gens.append(g.generation)
    info = g.membership()
    live = (info["registered"], info["generation"] == g.generation)
    g.shutdown()
    info = _mod(name, "_private.worker").global_worker().request_gcs(
        {"t": "gang_info", "name": "geninv"}, timeout=10)
    return {"pushed": pushed, "live": live,
            "after": (info["registered"], info["generation"] == gens[-1]),
            "steps": [b - a for a, b in zip(gens, gens[1:])]}


def test_generations_strictly_monotonic_across_reforms(clusters):
    jax_out, port_out = _both(_generations)
    assert jax_out == port_out
    assert port_out["pushed"] and port_out["live"] == (True, True)
    assert port_out["after"] == (False, True)
    assert all(s > 0 for s in port_out["steps"]), port_out


def _push_beats_timeout(name):
    rt = PKGS[name]
    wg = _mod(name, "train.worker_group")
    g = _form(name, 4, "pushbeat")
    try:
        gn = g.setup_gang_collectives()
        pid = rt.get(g.workers[2].pid.remote(), timeout=30)
        os.kill(pid, signal.SIGKILL)
        t0 = time.monotonic()
        kind, err = _raised(lambda: g.run_collective(
            "gang_barrier", gn, timeout=TIMEOUT_S))
        elapsed = time.monotonic() - t0
        alive = [rt.get(g.workers[r].ping.remote(), timeout=10)
                 for r in (0, 1, 3)]
        st = rt.get(rt.get_actor(f"_collective_{gn}").debug_state.remote(),
                    timeout=10)
        return {"kind": kind, "typed": isinstance(err, wg.WorkerGroupMemberLost),
                "lost_2": 2 in err.lost_ranks,
                "generation": err.generation == g.generation,
                "fast": elapsed < TIMEOUT_S / 4, "alive": alive,
                "pending": st["pending_ops"], "coord_lost_2": 2 in st["lost"]}
    finally:
        g.shutdown()


def test_membership_push_beats_the_flat_timeout(clusters):
    jax_out, port_out = _both(_push_beats_timeout)
    assert jax_out == port_out
    assert port_out == {"kind": "WorkerGroupMemberLost", "typed": True,
                        "lost_2": True, "generation": True, "fast": True,
                        "alive": [True] * 3, "pending": [],
                        "coord_lost_2": True}


def _formation_leak(name):
    rt = PKGS[name]
    wg = _mod(name, "train.worker_group")
    failpoints = _mod(name, "_private.failpoints")
    baseline = rt.available_resources().get("CPU", 0.0)
    failpoints.set_failpoints("gang.form=once:raise", 7)
    try:
        kind, _ = _raised(lambda: _form(name, 3, "leaky"))
    finally:
        failpoints.clear_failpoints()
    deadline = time.time() + 20
    avail = -1.0
    while time.time() < deadline:
        avail = rt.available_resources().get("CPU", 0.0)
        if avail >= baseline:
            break
        time.sleep(0.25)
    g = _form(name, 3, "leaky")
    try:
        out = g.run_collective("host_barrier", f"leaky_ok_{name}",
                               timeout=60)
    finally:
        g.shutdown()
    return {"kind": kind, "formation_error": kind == wg.
            WorkerGroupFormationError.__name__,
            "resources_back": avail >= baseline, "barrier": sorted(out)}


def test_formation_failure_leaks_nothing(clusters):
    jax_out, port_out = _both(_formation_leak)
    assert jax_out == port_out
    assert port_out == {"kind": "WorkerGroupFormationError",
                        "formation_error": True, "resources_back": True,
                        "barrier": [0, 1, 2]}


# ------------------------------------------------------------ loss ladder


class _FakeGroup:
    generation = 5

    def __init__(self, info):
        self._info = info

    def membership(self):
        return self._info


LADDER = {
    "reported": ([{"ok": True}, {"ok": False, "err_type":
                                  "CollectiveMemberLost",
                                  "lost_ranks": [2, 1]}], {}),
    "pipeline": ([{"ok": False, "err_type": "PipelineMemberLost",
                   "lost_ranks": [1]}], {}),
    "timeout_probed": ([{"ok": False, "err_type": "CollectiveTimeout"}],
                       {"registered": True, "lost": [3]}),
    "timeout_full": ([{"ok": False, "err_type": "CollectiveTimeout"}],
                     {"registered": True, "lost": []}),
    "plain": ([{"ok": True}, {"ok": False, "err_type": "ValueError",
                              "tb": "boom"}], {}),
    "clean": ([{"ok": True}, {"ok": True}], {}),
}


def _ladder(name):
    tr = _mod(name, "train.trainer")
    trainer_cls = getattr(tr, "TorchTrainer" if name == "port"
                          else "JaxTrainer")
    trainer = trainer_cls(lambda: None)
    out = {}
    for case, (outs, info) in LADDER.items():
        err = trainer._classify_failure(_FakeGroup(info), outs, 4)
        out[case] = (type(err).__name__, getattr(err, "lost_ranks", None),
                     getattr(err, "generation", None))
    return out


def test_the_typed_loss_ladder_matches():
    jax_out, port_out = _ladder("jax"), _ladder("port")
    assert jax_out == port_out
    assert port_out["reported"] == ("WorkerGroupMemberLost", [1, 2], 5)
    assert port_out["timeout_probed"] == ("WorkerGroupMemberLost", [3], 5)
    assert port_out["timeout_full"][0] == "TimeoutError"
    assert port_out["plain"][0] == "RuntimeError"
    assert port_out["clean"][0] == "NoneType"


def _pipeline_policy(name):
    tr = _mod(name, "train.trainer")
    wg = _mod(name, "train.worker_group")
    mp = _mod(name, "parallel.mpmd_pipeline")
    errs = [mp.PipelineMemberLost([1], 4, generation=2),
            mp.PipelineMemberLost([0, 3], 4),
            wg.WorkerGroupMemberLost([1], 4, stage_idx=2),
            wg.WorkerGroupMemberLost([0, 1, 2, 3], 4, stage_idx=1),
            wg.WorkerGroupMemberLost([0, 1, 2], 4, stage_idx=0),
            wg.WorkerGroupMemberLost([1], 4),
            RuntimeError("other")]
    return [tr.classify_pipeline_loss(e, n_stages=4, submesh_world=4,
                                      submesh_floor=2) for e in errs]


def test_classify_pipeline_loss_matches():
    assert _pipeline_policy("port") == _pipeline_policy("jax") == [
        ("resplit_pipeline", 3), ("resplit_pipeline", 2),
        ("reshape_submesh", 2, 3), ("resplit_pipeline", 3),
        ("reshape_submesh", 0, 2), None, None]


def test_typed_losses_pickle_and_read_as_the_reference():
    import pickle

    for name in ("jax", "port"):
        wg = _mod(name, "train.worker_group")
        mp = _mod(name, "parallel.mpmd_pipeline")
        col = _mod(name, "util.collective")
        for err in (wg.WorkerGroupMemberLost([3, 1], 4, "gone",
                                             generation=7, stage_idx=1),
                    mp.PipelineMemberLost([1], 2, generation=3,
                                          cause="push",
                                          checkpoint_path="/c"),
                    mp.PipelineDrainSignal("/c", 2, 4, [1], "drain"),
                    col.CollectiveMemberLost([2], 4, "killed"),
                    col.CollectiveTimeout("barrier", 3, [1], 2.0),
                    col.StaleCollectiveGeneration(1, 2)):
            back = pickle.loads(pickle.dumps(err))
            assert type(back) is type(err) and str(back) == str(err)
    port = _mod("port", "train.worker_group").WorkerGroupMemberLost(
        [3, 1], 4, "gone", generation=7, stage_idx=1)
    ref = _mod("jax", "train.worker_group").WorkerGroupMemberLost(
        [3, 1], 4, "gone", generation=7, stage_idx=1)
    assert str(port) == str(ref)


# ---------------------------------------------------------------- elastic

TOTAL_STEPS = 10
CRASH_STEP = 3


def _elastic_loop(config):
    """The reference test's loop in torch: x @ w against y, 8 rows split
    over the world, the gradient averaged over gloo, SGD 0.1, a
    checkpoint of w every step (rank 0 writes it), rank 1 of a 2-world
    exits once at CRASH_STEP."""
    import os
    import time

    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.train.checkpoint import (Checkpoint, load_pytree,
                                                save_pytree)

    ctx = train.get_context()
    world, rank = ctx.get_world_size(), ctx.get_world_rank()
    run_dir = config["run_dir"]
    rng = np.random.RandomState(0)
    x_full = rng.randn(8, 8).astype(np.float32)
    y_full = rng.randn(8, 8).astype(np.float32)
    rows = 8 // world
    x = torch.from_numpy(x_full[rank * rows:(rank + 1) * rows])
    y = torch.from_numpy(y_full[rank * rows:(rank + 1) * rows])
    w = torch.zeros(8, 8)
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        w = load_pytree(ckpt.path)["w"]
        start = int(ckpt.get_metadata()["step"]) + 1
    total = config.get("total_steps", 10)
    marker = os.path.join(run_dir, "crashed_once")
    for step in range(start, total):
        if (world == 2 and rank == 1 and step == config["crash_step"]
                and not os.path.exists(marker)):
            open(marker, "w").close()
            os._exit(1)
        time.sleep(config.get("step_sleep", 0.0))
        w.requires_grad_(True)
        loss = ((x @ w - y) ** 2).mean()
        (g,) = torch.autograd.grad(loss, w)
        loss = loss.detach()
        if world > 1:
            dist.all_reduce(g)
            dist.all_reduce(loss)
            g, loss = g / world, loss / world
        w = (w.detach() - 0.1 * g).contiguous()
        metrics = {"step": step, "loss": float(loss), "world": world,
                   "resumed_from": start}
        if rank == 0:
            ckpt_dir = os.path.join(run_dir, f"step_{step}")
            save_pytree({"w": w}, ckpt_dir)
            c = Checkpoint.from_directory(ckpt_dir)
            c.set_metadata({"step": step})
            train.report(metrics, checkpoint=c)
        else:
            train.report(metrics)


def _reference_loss(total):
    """The single-process trajectory of the reference test, in JAX."""
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(8, 8).astype(np.float32))
    y = jnp.asarray(rng.randn(8, 8).astype(np.float32))
    w = jnp.zeros((8, 8), jnp.float32)
    opt = optax.sgd(0.1)
    st = opt.init(w)
    for _ in range(total):
        loss, g = jax.value_and_grad(lambda w: jnp.mean((x @ w - y) ** 2))(w)
        up, st = opt.update(g, st)
        w = optax.apply_updates(w, up)
    return float(loss)


def _elastic_fit(tmp_path, name, total, scale_up, max_failures, sleep):
    from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)

    run_dir = str(tmp_path / name)
    os.makedirs(run_dir, exist_ok=True)
    return TorchTrainer(
        _elastic_loop,
        train_loop_config={"run_dir": run_dir, "step_sleep": sleep,
                           "total_steps": total, "crash_step": CRASH_STEP},
        scaling_config=ScalingConfig(num_workers=2, elastic_min_workers=1,
                                     elastic_scale_up=scale_up),
        run_config=RunConfig(storage_path=str(tmp_path), name=name,
                             failure_config=FailureConfig(
                                 max_failures=max_failures))).fit()


def test_elastic_dip_and_recover_2_1_2(clusters, tmp_path):
    """A rank dies at world 2 -> the group re-forms at 1 from the last
    checkpoint -> the capacity monitor sees the freed CPU -> the group
    re-forms at 2 at a report boundary and finishes there, with the
    single-process loss (the reference test's outcome)."""
    total = 16
    res = _elastic_fit(tmp_path, "elastic", total, True, 3, 0.4)
    assert res.error is None, res.error
    assert res.metrics["step"] == total - 1
    assert res.metrics["world"] == 2, res.metrics
    assert res.metrics["resumed_from"] >= 1
    assert abs(res.metrics["loss"] - _reference_loss(total)) < 1e-5


def test_elastic_downscale_only_when_scale_up_disabled(clusters, tmp_path):
    """Shrink-only: capacity presumed gone, the run finishes on one
    worker (the reference test's outcome), with the single-process
    loss."""
    res = _elastic_fit(tmp_path, "downonly", TOTAL_STEPS, False, 2, 0.0)
    assert res.error is None, res.error
    assert res.metrics["step"] == TOTAL_STEPS - 1
    assert res.metrics["world"] == 1
    assert 1 <= res.metrics["resumed_from"] <= CRASH_STEP
    assert abs(res.metrics["loss"] - _reference_loss(TOTAL_STEPS)) < 1e-5
