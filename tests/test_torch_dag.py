"""The port's ``dag`` and compiled graphs against the JAX package's, on
the CPU.

One module-scoped cluster of each package (``ray_tpu`` and
``ray_tpu_torch``). Every scenario builds the same lazy DAG in both
packages, from ``.bind`` on remote functions, actor classes and live
actor handles, runs it (``execute`` through the task path, or compiled
into a persistent actor pipeline), and compares the two packages'
results and exception class names: function and actor DAGs, input
attributes, each compiled chain, fan-out/fan-in, multi-output, constant
arguments, an error that propagates, admission under a full pipe,
teardown and the refusal of what a compiled DAG cannot run. The
scenarios are those of ``tests/test_compiled_dag.py``, without its
wall-clock comparison.

Remote functions and actor classes are defined inside the scenarios, so
cloudpickle ships them by value and no worker imports this module (which
imports JAX). The fixture shuts both clusters down and removes the port's
arenas and session directory, failures included.
"""

import glob
import importlib
import os
import shutil
import tempfile
import time

import pytest

import ray_tpu
import ray_tpu_torch


@pytest.fixture(scope="module")
def clusters():
    base = tempfile.gettempdir()
    root = tempfile.mkdtemp(prefix="rtg", dir=base if len(base) < 48
                            else "/tmp")
    saved = os.environ.get("RAY_TPU_TORCH_TMPDIR")
    os.environ["RAY_TPU_TORCH_TMPDIR"] = root
    session = None
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    try:
        ray_tpu.init(num_cpus=8, probe_tpu=False, ignore_reinit_error=True)
        ray_tpu_torch.init(num_cpus=8, probe_gpu=False)
        session = ray_tpu_torch._private.worker.global_worker().session_name
        yield {"jax": ray_tpu, "port": ray_tpu_torch}
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


def _dag(rt):
    return importlib.import_module(f"{rt.__name__}.dag")


def _both(clusters, scenario):
    """``scenario(rt, dag)`` on both packages: (jax, port)."""
    return tuple(scenario(clusters[n], _dag(clusters[n]))
                 for n in ("jax", "port"))


def _outcome(fn):
    """A value, or the class name of what it raised and its message."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return ("raised", type(e).__name__, str(e))


def _stage(rt):
    @rt.remote
    class Stage:
        def __init__(self, add):
            self.add = add

        def step(self, x):
            return x + self.add

        def boom(self, x):
            raise ValueError(f"bad input {x}")

        def slow(self, x):
            time.sleep(x)
            return x

    return Stage


def _compiled(dag_node, run, **kw):
    """``run(compiled)`` on ``dag_node`` compiled, torn down after."""
    c = dag_node.experimental_compile(**kw)
    try:
        return run(c)
    finally:
        c.teardown()


# ----------------------------------------------------------- task path


def test_function_dag_execute_matches(clusters):
    def scenario(rt, dag):
        @rt.remote
        def inc(x):
            return x + 1

        @rt.remote
        def add(a, b=0):
            return a + b

        with dag.InputNode() as inp:
            chain = inc.bind(inc.bind(inp))
            joined = add.bind(chain, b=inc.bind(inp))
        return (rt.get(chain.execute(3)), rt.get(joined.execute(5)),
                [type(n).__name__ for n in joined.topo_order()])

    jax_out, port_out = _both(clusters, scenario)
    assert jax_out == port_out
    assert port_out[:2] == (5, 13)


def test_input_attributes_and_options_match(clusters):
    def scenario(rt, dag):
        @rt.remote
        def pair(a, b):
            return [a, b]

        with dag.InputNode() as inp:
            node = pair.bind(inp[0], inp["k"])
        fn = pair.bind(1, 2).with_options(name="pair_named")
        missing = dag.InputNode(index=1)
        return (rt.get(node.execute({0: "zero", "k": "kay"})),
                rt.get(fn.execute()),
                _outcome(lambda: missing.execute(7)))

    jax_out, port_out = _both(clusters, scenario)
    assert jax_out == port_out
    assert port_out[0] == ["zero", "kay"] and port_out[2][1] == "ValueError"


def test_actor_dag_execute_matches(clusters):
    def scenario(rt, dag):
        Stage = _stage(rt)
        a = Stage.remote(10)
        with dag.InputNode() as inp:
            on_handle = a.step.bind(inp)
            built = Stage.bind(100).step.bind(on_handle)
            multi = dag.MultiOutputNode([on_handle, built])
        one = rt.get(built.execute(1))
        two = rt.get(built.execute(2))  # the ClassNode's actor is reused
        return one, two, rt.get(multi.execute(3))

    jax_out, port_out = _both(clusters, scenario)
    assert jax_out == port_out == (111, 112, [13, 113])


# ------------------------------------------------------------- compiled


def test_compiled_linear_pipeline_matches(clusters):
    def scenario(rt, dag):
        Stage = _stage(rt)
        a, b, c = Stage.remote(1), Stage.remote(10), Stage.remote(100)
        with dag.InputNode() as inp:
            node = c.step.bind(b.step.bind(a.step.bind(inp)))

        def run(cdag):
            first = [cdag.execute(0).get(timeout=30),
                     cdag.execute(5).get(timeout=30)]
            refs = [cdag.execute(i) for i in range(50)]
            return first, [r.get(timeout=30) for r in refs]

        return _compiled(node, run)

    jax_out, port_out = _both(clusters, scenario)
    assert jax_out == port_out
    assert port_out == ([111, 116], [111 + i for i in range(50)])


def test_compiled_class_bind_matches(clusters):
    def scenario(rt, dag):
        Stage = _stage(rt)
        with dag.InputNode() as inp:
            node = Stage.bind(7).step.bind(inp)
        return _compiled(node, lambda c: c.execute(1).get(timeout=30))

    assert _both(clusters, scenario) == (8, 8)


def test_compiled_error_propagates_and_the_pipe_lives_on(clusters):
    def scenario(rt, dag):
        Stage = _stage(rt)
        a, b = Stage.remote(1), Stage.remote(2)
        with dag.InputNode() as inp:
            bad = b.step.bind(a.boom.bind(inp))
            good = b.step.bind(a.step.bind(inp))

        def run(c):
            return [_outcome(lambda: c.execute(i).get(timeout=30))
                    for i in (3, 4)]

        return _compiled(bad, run), _compiled(good, run)

    jax_out, port_out = _both(clusters, scenario)
    assert jax_out == port_out
    assert port_out[0] == [("raised", "ValueError", "bad input 3"),
                           ("raised", "ValueError", "bad input 4")]
    assert port_out[1] == [("ok", 6), ("ok", 7)]


def test_compiled_fan_out_fan_in_matches(clusters):
    def scenario(rt, dag):
        @rt.remote
        class Doubler:
            def run(self, x):
                return x * 2

        @rt.remote
        class Squarer:
            def run(self, x):
                return x * x

        @rt.remote
        class Combiner:
            def run(self, a, b):
                return a + b

        d, s, c = Doubler.remote(), Squarer.remote(), Combiner.remote()
        with dag.InputNode() as inp:
            node = c.run.bind(d.run.bind(inp), s.run.bind(inp))
        compiled = dag.experimental_compile(node)
        try:
            return [compiled.execute(x).get(timeout=30) for x in (3, 5, 10)]
        finally:
            compiled.teardown()

    jax_out, port_out = _both(clusters, scenario)
    assert jax_out == port_out == [15, 35, 120]


def test_compiled_multi_output_matches(clusters):
    def scenario(rt, dag):
        @rt.remote
        class AddN:
            def __init__(self, n):
                self.n = n

            def run(self, x):
                return x + self.n

        a1, a2 = AddN.remote(10), AddN.remote(100)
        with dag.InputNode() as inp:
            node = dag.MultiOutputNode([a1.run.bind(inp), a2.run.bind(inp)])

        def run(c):
            return [c.execute(5).get(timeout=30), c.execute(7).get(timeout=30)]

        return _compiled(node, run)

    jax_out, port_out = _both(clusters, scenario)
    assert jax_out == port_out == [[15, 105], [17, 107]]


def test_compiled_constant_args_match(clusters):
    def scenario(rt, dag):
        @rt.remote
        class Scaler:
            def run(self, x, factor, offset=0):
                return x * factor + offset

        sc = Scaler.remote()
        with dag.InputNode() as inp:
            node = sc.run.bind(inp, 3, offset=1)
        return _compiled(node, lambda c: [c.execute(x).get(timeout=30)
                                          for x in (4, 0, -2)])

    jax_out, port_out = _both(clusters, scenario)
    assert jax_out == port_out == [13, 1, -5]


def test_compiled_admission_times_out_on_a_full_pipe(clusters):
    """One execution in flight at most: a second ``execute`` with a short
    timeout raises ``AdmissionTimeout`` (a ``TimeoutError``) while the
    first is still running, then is admitted once it completes."""
    def scenario(rt, dag):
        Stage = _stage(rt)
        a = Stage.remote(0)
        with dag.InputNode() as inp:
            node = a.slow.bind(inp)

        def run(c):
            first = c.execute(1.0)
            full = _outcome(lambda: c.execute(0.0, timeout=0.1))
            return (full[:2], first.get(timeout=30),
                    c.execute(0.0, timeout=30).get(timeout=30),
                    issubclass(dag.compiled.AdmissionTimeout, TimeoutError))

        return _compiled(node, run, max_inflight=1)

    jax_out, port_out = _both(clusters, scenario)
    assert jax_out == port_out
    assert port_out == (("raised", "AdmissionTimeout"), 1.0, 0.0, True)


def test_compiled_teardown_blocks_execute(clusters):
    def scenario(rt, dag):
        Stage = _stage(rt)
        a = Stage.remote(1)
        with dag.InputNode() as inp:
            node = a.step.bind(inp)
        c = node.experimental_compile()
        before = c.execute(0).get(timeout=30)
        c.teardown()
        c.teardown()  # idempotent
        return before, _outcome(lambda: c.execute(1))[:2]

    jax_out, port_out = _both(clusters, scenario)
    assert jax_out == port_out == (1, ("raised", "RuntimeError"))


def test_compiled_refuses_what_it_cannot_run(clusters):
    """A function DAG, a DAG-valued kwarg and a stage fed only constants
    are refused at compile time with the reference's ``ValueError``."""
    def scenario(rt, dag):
        Stage = _stage(rt)

        @rt.remote
        def f(x):
            return x

        a, b = Stage.remote(1), Stage.remote(2)
        with dag.InputNode() as inp:
            kw_node = b.step.bind(x=a.step.bind(inp))
            fn_upstream = a.step.bind(f.bind(inp))
        const_only = a.step.bind(1)
        return [_outcome(lambda n=n: dag.experimental_compile(n))[:2]
                for n in (f.bind(1), kw_node, fn_upstream, const_only)]

    jax_out, port_out = _both(clusters, scenario)
    assert jax_out == port_out
    assert port_out == [("raised", "ValueError")] * 4
