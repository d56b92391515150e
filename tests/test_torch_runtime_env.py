"""The port's runtime_env against the JAX package's, on the CPU.

One module-scoped cluster per package runs the same scenarios, taken from
``test_runtime_env.py``, ``test_runtime_env_pip.py``,
``test_runtime_env_conda.py`` and ``test_runtime_env_container.py``, and
each test compares the two packages' results (names aside). The port's
own parts are checked on the port alone, with what the JAX package does
recorded beside them: its forwarded container prefixes, and a pip-env
actor leased a GPU, pinned to it whatever its ``env_vars`` say.

Both clusters take their sessions, venvs and package caches from one
temporary root that the fixture removes, with the port's arenas,
failures included. Remote functions are defined inside the
scenarios, so cloudpickle ships them by value and no worker imports this
module (which imports JAX).
"""

import ast
import importlib
import io
import json
import os
import re
import shutil
import stat
import sys
import tempfile
import textwrap
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch._private.node import session_segments
from ray_tpu_torch.runtime_env.wheel import write_wheel

REPO = Path(__file__).resolve().parents[1]
GPUS = 2
PROBE = "rtpt_env_probe"
MAGIC = "isolated-515151"
PACKAGES = {"jax": "ray_tpu", "port": "ray_tpu_torch"}

# A container runtime that records its argv, applies its ``-e`` variables
# and execs the inner command with this host's python (the image's python
# in a real one), as test_runtime_env_container.py's does.
FAKE_RUNTIME = textwrap.dedent("""\
    #!{python}
    import json, os, sys
    args = sys.argv[1:]
    with open({log!r}, "a") as f:
        f.write(json.dumps(args) + "\\n")
    i = next(k for k, a in enumerate(args) if a.startswith("fake.io/"))
    env = dict(os.environ)
    k = 0
    while k < i:
        if args[k] == "-e":
            key, _, v = args[k + 1].partition("=")
            env[key] = v
            k += 2
        else:
            k += 1
    cmd = args[i + 1:]
    cmd[0] = sys.executable
    os.execvpe(cmd[0], cmd, env)
""")


def probe_wheel(directory: str) -> str:
    """A local wheel of ``PROBE`` (``write_wheel``: no setuptools, wheel or
    index)."""
    return write_wheel(directory, PROBE, {
        f"{PROBE}/__init__.py": f"MAGIC = {MAGIC!r}\n".encode()})


def _pip(wheel):
    return {"pip": {"packages": [wheel], "no_index": True, "no_deps": True}}


def _plain(value):
    """A value with the port's names turned into the JAX package's."""
    if isinstance(value, str):
        value = re.sub(r"\bray_tpu_torch\b", "ray_tpu", value)
        return re.sub(r"\bRAY_TPU_TORCH_", "RAY_TPU_", value)
    if isinstance(value, dict):
        return {_plain(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


def _outcome(fn):
    """A value, or the class name and message of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error is the result
        return ("raised", type(e).__name__, str(e))


@pytest.fixture(scope="module")
def env_root():
    """The module's root: both packages' sessions, venvs, package caches
    and fake container runtime (a short path: UNIX socket paths in it stay
    under 108 bytes)."""
    base = tempfile.gettempdir()
    root = tempfile.mkdtemp(prefix="rte", dir=base if len(base) < 48
                            else "/tmp")
    runtime = os.path.join(root, "fake-podman")
    log = os.path.join(root, "invocations.jsonl")
    with open(runtime, "w") as f:
        f.write(FAKE_RUNTIME.format(python=sys.executable, log=log))
    os.chmod(runtime, os.stat(runtime).st_mode | stat.S_IEXEC)
    env = {"RAY_TPU_TORCH_TMPDIR": root,
           "RAY_TPU_TMPDIR": os.path.join(root, "j")}
    for prefix, side in (("RAY_TPU_", "jax"), ("RAY_TPU_TORCH_", "port")):
        env[prefix + "VENV_ROOT"] = os.path.join(root, side, "venvs")
        env[prefix + "PKG_CACHE"] = os.path.join(root, side, "pkgs")
        env[prefix + "CONTAINER_RUNTIME"] = runtime
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield {"root": root, "log": log, "wheel": probe_wheel(root)}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def clusters(env_root):
    session = None
    # a cluster another module left behind would lack this one's settings
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    try:
        ray_tpu_torch.init(num_cpus=4, num_gpus=GPUS, probe_gpu=False)
        session = ray_tpu_torch._private.worker.global_worker().session_name
        ray_tpu.init(num_cpus=4, probe_tpu=False, resources={"GPU": GPUS},
                     ignore_reinit_error=True)
        yield {"jax": ray_tpu, "port": ray_tpu_torch, **env_root}
    finally:
        try:
            ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            for p in session_segments(session) if session else []:
                try:
                    os.unlink(p)
                except OSError:
                    pass


def _both_at_once(scenario, *args):
    """``scenario(rt, *args)`` on both packages at once: (jax, port)."""
    with ThreadPoolExecutor(2) as pool:
        jax_f, port_f = (pool.submit(scenario, rt, *args)
                         for rt in (ray_tpu, ray_tpu_torch))
        return jax_f.result(), port_f.result()


def _renv(name):
    return importlib.import_module(f"{PACKAGES[name]}.runtime_env")


# ------------------------------------------------------------- packaging


def test_package_directory_gives_the_same_uri(tmp_path):
    d = tmp_path / "pkg"
    (d / "sub").mkdir(parents=True)
    (d / "__pycache__").mkdir()
    (d / "__pycache__" / "junk.pyc").write_text("x")
    (d / "a.txt").write_text("hello")
    (d / "sub" / "b.py").write_text("X = 1")

    def scenario(name):
        renv = _renv(name)
        uri, data = renv.package_directory(str(d))
        again = renv.package_directory(str(d))
        fetched = []

        def fetch(u):
            fetched.append(u)
            return data

        cache = str(tmp_path / f"cache_{name}")
        paths = [renv.ensure_local_package(uri, fetch, cache_dir=cache)
                 for _ in range(2)]
        with open(os.path.join(paths[0], "sub", "b.py")) as f:
            content = f.read()
        names = sorted(zipfile.ZipFile(io.BytesIO(data)).namelist())
        return (uri, data, again == (uri, data), names, len(fetched),
                paths[0] == paths[1], content)

    jax_out = scenario("jax")
    port_out = scenario("port")
    assert jax_out == port_out
    uri, _, same, names, fetches, cached, content = port_out
    assert uri.startswith("pkg://") and same and cached and fetches == 1
    assert names == ["a.txt", "sub/b.py"] and content == "X = 1"
    (d / "a.txt").write_text("changed")
    changed = {n: _renv(n).package_directory(str(d))[0] for n in PACKAGES}
    assert changed["jax"] == changed["port"] != uri


# ------------------------------------------------------------ validation

CASES = [
    {"nonsense_key": 1},
    {"conda": "myenv"},
    {"image_uri": "img:1", "pip": ["numpy"]},
    {"uv": ["x"], "pip": ["y"]},
    {"image_uri": "img:1", "env_vars": {"A": "1"}},
    {"env_vars": {"A": [1]}},
    {"env_vars": "A=1"},
    {"working_dir": "s3://bucket/x"},
    {"py_modules": "x"},
    {"pip": 3},
    {"pip": [3]},
    {"image_uri": {"image_uri": "x", "run_options": [1]}},
    {"config": {"setup_timeout_seconds": 10}, "env_vars": {"B": 2}},
]


def test_validation_and_plugins_match(monkeypatch):
    def scenario(name):
        renv = _renv(name)
        pip_env = importlib.import_module(f"{PACKAGES[name]}.runtime_env"
                                          ".pip_env")
        out = [_outcome(lambda c=c: renv.validate_runtime_env(c))
               for c in CASES]
        out.append(_outcome(lambda: dict(renv.RuntimeEnv(
            env_vars={"A": "1"}, pip=["numpy"]))))
        out.append(_outcome(lambda: renv.RuntimeEnv(conda="x")))
        out.append([p.name for p in renv.get_plugins()])

        class Marker(renv.RuntimeEnvPlugin):
            name = "marker"

            def create(self, value, ctx, fetch):
                ctx.env_vars["MARKER_VALUE"] = str(value)

        renv.register_plugin(Marker())
        try:
            ctx = renv.setup_runtime_env({"marker": 42},
                                         fetch=lambda u: None, apply=False)
            out.append(dict(ctx.env_vars))
        finally:
            renv.unregister_plugin("marker")
        # pip envs are met at the worker's spawn: the worker-side plugin
        # checks that the scheduler routed the task to its env's pool
        var = "RAY_TPU_ENV_KEY" if name == "jax" else "RAY_TPU_TORCH_ENV_KEY"
        key = pip_env.env_key(pip_env.normalize_spec(["numpy"], "pip"))
        for have in (key, "somethingelse"):
            monkeypatch.setenv(var, have)
            out.append(_outcome(lambda: renv.setup_runtime_env(
                {"pip": ["numpy"]}, fetch=lambda u: None,
                apply=False).taints_worker))
        monkeypatch.delenv(var)
        out.append(key)
        return _plain(out)

    jax_out = scenario("jax")
    port_out = scenario("port")
    assert jax_out == port_out
    assert port_out[0][:2] == ("raised", "ValueError")
    assert "unknown runtime_env" in port_out[0][2]
    assert "conda" in port_out[1][2]
    assert "cannot be combined" in port_out[2][2] and \
        "cannot be combined" in port_out[3][2]
    assert port_out[4] == ("ok", None) and port_out[12] == ("ok", None)
    assert port_out[len(CASES) + 3] == {"MARKER_VALUE": "42"}
    assert port_out[-3] == ("ok", False)
    assert port_out[-2][:2] == ("raised", "RuntimeError") and \
        "env-pool routing" in port_out[-2][2]


def test_conda_is_gated_on_its_binary(monkeypatch, tmp_path):
    """Neither machine has conda: with no conda, micromamba or mamba on
    PATH, both packages refuse the env at the spawn with the same error,
    and route and key a spec the same way."""
    monkeypatch.setenv("PATH", str(tmp_path))

    def scenario(name):
        conda = importlib.import_module(
            f"{PACKAGES[name]}.runtime_env.conda_env")
        pip_env = importlib.import_module(
            f"{PACKAGES[name]}.runtime_env.pip_env")
        return _plain([
            conda.normalize_conda("myenv"),
            conda.normalize_conda({"dependencies": ["python=3.12"]}),
            _outcome(lambda: conda.normalize_conda(42)),
            pip_env.spawn_spec_from_renv({"conda": "base"}),
            pip_env.spawn_spec_from_renv({"pip": ["x"]})["tool"],
            conda.conda_key(conda.normalize_conda("env-a")),
            conda.conda_key(conda.normalize_conda("env-b")),
            _outcome(lambda: conda.ensure_conda_env(
                {"tool": "conda", "name": "whatever"})),
            _outcome(lambda: conda.ensure_conda_env(
                conda.normalize_conda({"dependencies": []})))])

    jax_out = scenario("jax")
    port_out = scenario("port")
    assert jax_out == port_out
    assert port_out[0] == {"tool": "conda", "name": "myenv"}
    assert port_out[5] != port_out[6]
    assert port_out[7][:2] == ("raised", "RuntimeError")
    assert "conda/micromamba" in port_out[7][2] and port_out[8] == port_out[7]


# -------------------------------------------------------- code shipping


def _code_shipping(rt, tmp_path):
    proj = tmp_path / "proj"
    proj.mkdir(parents=True, exist_ok=True)
    (proj / "config.txt").write_text("payload-123")
    (proj / "helper.py").write_text("VALUE = 'from-helper'\n")
    pkg = tmp_path / "shipped_pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "__init__.py").write_text("NAME = 'shipped'\n")
    (pkg / "mod.py").write_text("def f():\n    return 99\n")

    @rt.remote
    def read_env():
        import os

        return os.environ.get("MY_RENV_VAR")

    @rt.remote
    def use_working_dir():
        import os

        import helper

        with open("config.txt") as f:
            return f.read(), helper.VALUE, os.path.basename(os.getcwd())

    @rt.remote
    def use_module():
        import shipped_pkg
        from shipped_pkg import mod

        return shipped_pkg.NAME, mod.f()

    @rt.remote
    class EnvActor:
        def get(self, k):
            import os

            return os.environ.get(k)

        def both(self):
            import helper
            import shipped_pkg

            return helper.VALUE, shipped_pkg.NAME

    out = {"env_vars": rt.get(read_env.options(runtime_env={
        "env_vars": {"MY_RENV_VAR": "abc"}}).remote(), timeout=120)}
    # a later plain task does not see it: the dedicated worker retired
    out["after"] = rt.get(read_env.remote(), timeout=120)
    content = rt.get(use_working_dir.options(
        runtime_env={"working_dir": str(proj)}).remote(), timeout=120)
    out["working_dir"] = content[:2]
    out["cwd_is_the_uri"] = len(content[2]) == 20
    out["py_modules"] = rt.get(use_module.options(
        runtime_env={"py_modules": [str(pkg)]}).remote(), timeout=120)
    a = EnvActor.options(runtime_env={
        "env_vars": {"ACTOR_RENV": "yes"}, "working_dir": str(proj),
        "py_modules": [str(pkg)]}).remote()
    out["actor"] = (rt.get(a.get.remote("ACTOR_RENV"), timeout=120),
                    rt.get(a.both.remote(), timeout=120))
    rt.kill(a)
    return out


def test_env_vars_working_dir_py_modules_and_actors_match(clusters,
                                                          tmp_path):
    jax_out = _code_shipping(ray_tpu, tmp_path / "jax")
    port_out = _code_shipping(ray_tpu_torch, tmp_path / "port")
    assert jax_out == port_out
    assert port_out == {
        "env_vars": "abc", "after": None,
        "working_dir": ("payload-123", "from-helper"),
        "cwd_is_the_uri": True, "py_modules": ("shipped", 99),
        "actor": ("yes", ("from-helper", "shipped"))}


def _serve_env(rt):
    serve = importlib.import_module(f"{rt.__name__}.serve")
    serve.start()
    try:
        @serve.deployment(ray_actor_options={"runtime_env": {
            "env_vars": {"SERVE_RENV": "on"}}})
        class Env:
            def __call__(self, key):
                import os

                return os.environ.get(key)

        h = serve.run(Env.bind(), name="renv", route_prefix=None)
        return [h.remote(k).result(timeout=120)
                for k in ("SERVE_RENV", "MY_RENV_VAR")]
    finally:
        serve.shutdown()


def test_serve_ray_actor_options_carry_the_env(clusters):
    jax_out, port_out = _both_at_once(_serve_env)
    assert jax_out == port_out == ["on", None]


# ------------------------------------------------------------ pip envs


def _pip_worker(rt, wheel):
    @rt.remote(runtime_env=_pip(wheel))
    def probe():
        import os
        import sys

        import numpy as np

        mod = __import__(PROBE)
        key = next((v for k, v in os.environ.items()
                    if k.endswith("ENV_KEY")), "")
        try:
            import torch

            torch_version = torch.__version__
        except ImportError:
            torch_version = None
        return (mod.MAGIC, int(np.arange(5).sum()), key, sys.executable,
                torch_version)

    @rt.remote
    def base_probe():
        try:
            __import__(PROBE)
            return "visible"
        except ImportError:
            return "hidden"

    first = rt.get(probe.remote(), timeout=300)
    # the venv worker stays in its pool: a second call reuses its env
    second = rt.get(probe.remote(), timeout=120)
    return first, second, rt.get(base_probe.remote(), timeout=120)


def test_pip_env_worker_imports_a_local_wheel(clusters):
    with pytest.raises(ImportError):
        __import__(PROBE)  # the driver cannot import it
    jax_out, port_out = _both_at_once(_pip_worker, clusters["wheel"])
    (jmagic, jsum, jkey, _, _), jsecond, jbase = jax_out
    (magic, total, key, exe, torch_version), second, base = port_out
    assert (jmagic, jsum, jbase) == (magic, total, base) == \
        (MAGIC, 10, "hidden")
    assert key and jkey and second[:4] == (magic, total, key, exe)
    # the port's worker runs the venv's interpreter, the parent's torch on
    # its path after the venv's site dir
    assert exe.startswith(os.environ["RAY_TPU_TORCH_VENV_ROOT"])
    assert os.path.basename(os.path.dirname(os.path.dirname(exe))) == key
    import torch

    assert torch_version == torch.__version__


def _doomed(rt):
    @rt.remote(runtime_env={"pip": {"packages": ["/nonexistent/x.whl"],
                                    "no_index": True}})
    class Doomed:
        def ping(self):
            return 1

    a = Doomed.remote()
    try:
        rt.get(a.ping.remote(), timeout=240)
    except Exception as e:  # noqa: BLE001 - the error is the result
        return type(e).__name__, "runtime env setup failed" in str(e)
    return "ok", False


def test_an_unbuildable_env_fails_its_actor_typed(clusters):
    """The GCS fails the consumers of an env that failed to build three
    times running with the build's error (reference:
    RuntimeEnvSetupError), instead of building it forever."""
    jax_out, port_out = _both_at_once(_doomed)
    assert jax_out == port_out == ("ActorDiedError", True)


def test_a_pip_env_actor_leased_a_gpu_is_pinned(clusters):
    """On the port's cluster (2 GPUs declared, none probed) a pip-env
    actor with num_gpus=1 runs in its venv pinned to one card; env_vars
    naming CUDA_VISIBLE_DEVICES may not move a GPU lease to other cards
    (the actor or task fails typed, naming both values), and the same
    value is taken. The JAX package pins no GPU (ROADMAP C3), so its
    env_vars set the variable."""
    rt, wheel = ray_tpu_torch, clusters["wheel"]

    @rt.remote(num_gpus=1, runtime_env=_pip(wheel))
    class Pinned:
        def probe(self):
            import os
            import sys

            import ray_tpu_torch as rtt

            return (__import__(PROBE).MAGIC, sys.executable,
                    rtt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES"))

    a = Pinned.remote()
    magic, exe, ids, visible = rt.get(a.probe.remote(), timeout=300)
    assert magic == MAGIC and len(ids) == 1 and visible == ids[0]
    assert exe.startswith(os.environ["RAY_TPU_TORCH_VENV_ROOT"])
    # a holds its card, so b is leased the other one: its env_vars name
    # a's
    other = ids[0]
    b = Pinned.options(runtime_env={**_pip(wheel), "env_vars": {
        "CUDA_VISIBLE_DEVICES": other}}).remote()
    with pytest.raises(rt.ActorDiedError, match="GPUPinConflictError") as e:
        rt.get(b.probe.remote(), timeout=300)
    assert f"CUDA_VISIBLE_DEVICES={other!r}" in str(e.value)
    rt.kill(a)

    def gpus_back():
        deadline = time.time() + 30  # the actors' and tasks' leases
        while rt.available_resources().get("GPU") != GPUS:
            assert time.time() < deadline, rt.available_resources()
            time.sleep(0.1)

    def gpu_task(pkg_rt, env):
        @pkg_rt.remote(num_gpus=1)
        def visible():
            import os

            return os.environ.get("CUDA_VISIBLE_DEVICES")

        return pkg_rt.get(visible.options(
            runtime_env={"env_vars": env}).remote(), timeout=120)

    from ray_tpu_torch.accelerators import GPUPinConflictError

    gpus_back()
    with pytest.raises(GPUPinConflictError, match="'5'"):
        gpu_task(rt, {"CUDA_VISIBLE_DEVICES": "5"})
    gpus_back()
    # the lowest free card is leased first
    assert gpu_task(rt, {"CUDA_VISIBLE_DEVICES": "0"}) == "0"
    assert gpu_task(ray_tpu, {"CUDA_VISIBLE_DEVICES": "5"}) == "5"
    gpus_back()


# ----------------------------------------------------------- containers


def test_the_port_forwards_its_own_prefixes_into_a_container(clusters,
                                                             tmp_path):
    env = {"RAY_TPU_TORCH_ENV_KEY": "k1", "RAY_TPU_ENV_KEY": "k0",
           "CUDA_VISIBLE_DEVICES": "0", "NVIDIA_DRIVER_CAPABILITIES": "all",
           "TORCH_HOME": "/t", "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "-x",
           "TPU_NAME": "v5", "LIBTPU_INIT_ARGS": "-y", "TMPDIR": "/tmp",
           "HOME": "/root", "PATH": "/bin"}
    sess = tmp_path / "sess"
    sess.mkdir()

    def forwarded(name):
        container = importlib.import_module(
            f"{PACKAGES[name]}.runtime_env.container")
        argv, out_env = container.wrap_spawn(
            container.normalize_value({"image_uri": "fake.io/img:1",
                                       "run_options": ["--memory=1g"]}),
            ["/usr/bin/python", "-S", "-c", "code"], env, str(sess),
            "/repo-not-there")
        i = argv.index("fake.io/img:1")
        return (sorted(argv[k + 1].split("=")[0] for k in range(i)
                       if argv[k] == "-e"), argv[1], argv[i - 1],
                argv[i + 1], out_env == env)

    jax_out, port_out = forwarded("jax"), forwarded("port")
    assert jax_out[1:] == port_out[1:] == ("run", "--memory=1g", "python3",
                                           True)
    assert port_out[0] == ["CUDA_VISIBLE_DEVICES",
                           "NVIDIA_DRIVER_CAPABILITIES",
                           "RAY_TPU_TORCH_ENV_KEY", "TMPDIR", "TORCH_HOME"]
    assert jax_out[0] == ["JAX_PLATFORMS", "LIBTPU_INIT_ARGS",
                          "RAY_TPU_ENV_KEY", "RAY_TPU_TORCH_ENV_KEY",
                          "TMPDIR", "TPU_NAME", "XLA_FLAGS"]


def _container_pool(rt, image):
    @rt.remote(runtime_env={"image_uri": image})
    def which_env():
        import os

        return next((v for k, v in os.environ.items()
                     if k.endswith("ENV_KEY")), "")

    @rt.remote
    def base_env():
        import os

        return next((v for k, v in os.environ.items()
                     if k.endswith("ENV_KEY")), "")

    key = rt.get(which_env.remote(), timeout=180)
    return bool(key), rt.get(base_env.remote(), timeout=120)


def test_image_uri_runs_in_a_container_pool(clusters):
    """Both clusters spawn an image_uri task's worker through the fake
    runtime (set before the clusters started) into a pool of its own;
    base tasks stay in the base pool."""
    jax_out, port_out = _both_at_once(
        lambda rt: _container_pool(rt, f"fake.io/{rt.__name__}:v3"))
    assert jax_out == port_out == (True, "")
    with open(clusters["log"]) as f:
        runs = [json.loads(line) for line in f]
    for pkg in PACKAGES.values():
        run = next(r for r in runs if f"fake.io/{pkg}:v3" in r)
        assert run[0] == "run" and "--network=host" in run
        env_keys = {run[k + 1].split("=")[0] for k in range(len(run))
                    if run[k] == "-e"}
        prefix = "RAY_TPU_TORCH_" if pkg == "ray_tpu_torch" else "RAY_TPU_"
        assert f"{prefix}ENV_KEY" in env_keys


# -------------------------------------------------------------- copies

# Modules copied from the reference with only their names changed; the
# container's forwarded prefixes differ (CHANGES.md).
VERBATIM = ("runtime_env/__init__.py", "runtime_env/context.py",
            "runtime_env/plugin.py", "runtime_env/packaging.py",
            "runtime_env/runtime_env.py", "runtime_env/pip_env.py",
            "runtime_env/conda_env.py")


def _renamed(text: str) -> str:
    text = re.sub(r"\bray_tpu\b(?!_torch)", "ray_tpu_torch", text)
    text = re.sub(r"\bRAY_TPU_(?!TORCH_)", "RAY_TPU_TORCH_", text)
    return re.sub(r"\brtpu", "rtpt", text)


def _code(text: str) -> str:
    """The module's syntax tree without docstrings."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
    return ast.dump(tree)


@pytest.mark.parametrize("module", VERBATIM)
def test_runtime_env_copy_is_the_reference_code_but_for_names(module):
    got = (REPO / "ray_tpu_torch" / module).read_text()
    want = _renamed((REPO / "ray_tpu" / module).read_text())
    assert _code(got) == _code(want)


def test_the_container_copy_differs_only_by_its_prefixes():
    got = (REPO / "ray_tpu_torch/runtime_env/container.py").read_text()
    want = _renamed((REPO / "ray_tpu/runtime_env/container.py").read_text())
    want = want.replace(
        '("RAY_TPU_TORCH_", "JAX_", "XLA_", "TPU_", "LIBTPU_")',
        '("RAY_TPU_TORCH_", "CUDA_", "NVIDIA_", "TORCH_")')
    assert _code(got) == _code(want)
