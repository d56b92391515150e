"""Parity of the PyTorch port's ops (ray_tpu_torch.ops) with the JAX
package's, on the CPU in fp32.

The same numpy inputs, made from a seed, go through both packages. The
port's flash attention runs its plain blockwise version here (a CPU
tensor); the JAX kernel runs in Pallas interpret mode. Tolerances are
atol = rtol = 1e-5: both sides compute in fp32 and differ only in the
order of their sums.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import layers as jlayers
from ray_tpu.ops import quant as jquant
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import layers as tlayers
from ray_tpu_torch.ops import quant as tquant

TOL = dict(atol=1e-5, rtol=1e-5)
REPO = Path(__file__).resolve().parent.parent



@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU thread pool small: the suite runs files in
    parallel workers, beside timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


# ------------------------------------------------------------- layers

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, scale = _randn(rng, 2, 5, 64), _randn(rng, 64) * 0.1
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))


def test_rope_tables_and_application_match_jax():
    rng = np.random.default_rng(1)
    tc, ts = tlayers.rope_frequencies(32, 64, 10000.0)
    jc, js = jlayers.rope_frequencies(32, 64, 10000.0)
    _close(tc, jc)
    _close(ts, js)
    x = _randn(rng, 2, 8, 3, 32)
    pos = rng.integers(0, 64, size=(2, 8))
    _close(tlayers.apply_rope(torch.from_numpy(x), tc, ts),
           jlayers.apply_rope(jnp.asarray(x), jc, js))
    _close(tlayers.apply_rope(torch.from_numpy(x), tc, ts,
                              torch.from_numpy(pos)),
           jlayers.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos)))


def test_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    x = _randn(rng, 4, 16)
    wg, wu, wd = _randn(rng, 16, 32), _randn(rng, 16, 32), _randn(rng, 32, 16)
    _close(tlayers.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))),
           jlayers.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.default_rng(3)
    logits = _randn(rng, 3, 7, 50) * 3
    labels = rng.integers(0, 50, size=(3, 7))
    labels[0, :2] = -100
    tl, tn = tlayers.cross_entropy_loss(torch.from_numpy(logits),
                                        torch.from_numpy(labels),
                                        z_loss=z_loss)
    jl, jn = jlayers.cross_entropy_loss(jnp.asarray(logits),
                                        jnp.asarray(labels), z_loss=z_loss)
    _close(tl, jl)
    assert float(tn) == float(jn) == 19.0


# -------------------------------------------------------------- quant

def test_quantize_array_and_mm_match_jax():
    rng = np.random.default_rng(4)
    w = _randn(rng, 32, 24)
    w[:, 3] = 0.0  # an all-zero channel takes scale 1
    tq = tquant.quantize_array(torch.from_numpy(w))
    jq = jquant.quantize_array(jnp.asarray(w))
    np.testing.assert_array_equal(tq.w.numpy(), np.asarray(jq.w))
    _close(tq.s, jq.s)
    x = _randn(rng, 5, 32)
    _close(tquant.mm(torch.from_numpy(x), tq), jquant.mm(jnp.asarray(x), jq))
    _close(tquant.mm(torch.from_numpy(x), torch.from_numpy(w)),
           jquant.mm(jnp.asarray(x), jnp.asarray(w)))


def test_quantize_params_and_nbytes_match_jax():
    rng = np.random.default_rng(5)
    layer = {k: _randn(rng, 16, 16) for k in
             ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
    layer["attn_norm"] = _randn(rng, 16)
    tree = {"embedding": _randn(rng, 40, 16), "lm_head": _randn(rng, 16, 40),
            "norm": _randn(rng, 16), "layers": [layer, dict(layer)]}
    jtree = {"embedding": jnp.asarray(tree["embedding"]),
             "lm_head": jnp.asarray(tree["lm_head"]),
             "norm": jnp.asarray(tree["norm"]),
             "layers": [{k: jnp.asarray(v) for k, v in lay.items()}
                        for lay in tree["layers"]]}
    ttree = {"embedding": torch.from_numpy(tree["embedding"]),
             "lm_head": torch.from_numpy(tree["lm_head"]),
             "norm": torch.from_numpy(tree["norm"]),
             "layers": [{k: torch.from_numpy(v) for k, v in lay.items()}
                        for lay in tree["layers"]]}
    tqp, jqp = tquant.quantize_params(ttree), jquant.quantize_params(jtree)
    assert isinstance(tqp["lm_head"], tquant.Q8)
    assert isinstance(tqp["layers"][1]["w_down"], tquant.Q8)
    assert not isinstance(tqp["layers"][0]["attn_norm"], tquant.Q8)
    np.testing.assert_array_equal(tqp["layers"][1]["wq"].w.numpy(),
                                  np.asarray(jqp["layers"][1]["wq"].w))
    assert tquant.quantized_nbytes(tqp) == jquant.quantized_nbytes(jqp)
    assert tquant.quantized_nbytes(ttree) == jquant.quantized_nbytes(jtree)


# ---------------------------------------------------------- attention

B, L, H, D = 1, 256, 2, 64


def _qkv(seed, b=B, lq=L, lk=L, h=H, hkv=H, d=D):
    rng = np.random.default_rng(seed)
    return _randn(rng, b, lq, h, d), _randn(rng, b, lk, hkv, d), \
        _randn(rng, b, lk, hkv, d)


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 128),
                                             (256, 256), (64, 128),
                                             (128, 64), (256, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_flash_matches_pallas_kernel(block_q, block_k, causal):
    q, k, v = _qkv(0)
    want = jattn.pallas_flash_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block_q, block_k=block_k, interpret=True)
    got = tattn.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=block_q, block_k=block_k)
    _close(got, want)


@pytest.mark.parametrize("lq,hkv,causal", [
    (200, 2, True),     # ragged L: no block size divides it
    (77, 2, False),
    (256, 1, True),     # GQA, 2 query heads per kv head
    (130, 1, False),    # GQA, ragged, full attention
])
def test_flash_matches_dense_oracle(lq, hkv, causal):
    q, k, v = _qkv(1, lq=lq, lk=lq, hkv=hkv)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal)
    _close(tattn.flash_attention(tq, tk, tv, causal=causal), want)
    _close(tattn.dense_attention(tq, tk, tv, causal=causal), want)


def test_dense_oracle_offsets_and_segments_match_jax():
    q, k, v = _qkv(2, lq=24, lk=40, hkv=1)
    seg = np.repeat(np.arange(3), 8)[None]
    want = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True)
    _close(tattn.dense_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=True), want)
    q2, k2, v2 = _qkv(3, lq=24, lk=24)
    want = jattn.dense_attention(jnp.asarray(q2), jnp.asarray(k2),
                                 jnp.asarray(v2), causal=True,
                                 segment_ids=jnp.asarray(seg))
    got = tattn.flash_attention(*map(torch.from_numpy, (q2, k2, v2)),
                                causal=True,
                                segment_ids=torch.from_numpy(seg))
    _close(got, want)


@pytest.mark.parametrize("d,dtype,kv_dtype,seg,takes", [
    (16, torch.float32, None, False, False),     # LLAMA_DEBUG's heads
    (32, torch.bfloat16, None, False, False),
    (64, torch.float32, None, False, True),
    (128, torch.bfloat16, None, False, True),
    (64, torch.float16, None, False, False),
    (64, torch.bfloat16, torch.float32, False, False),
    (128, torch.float32, None, True, False),
], ids=["d16", "d32", "d64", "d128", "fp16", "mixed", "segments"])
def test_kernel_takes_decides_kernel_or_dense(d, dtype, kv_dtype, seg,
                                              takes):
    """The predicate that sends a CUDA call to the kernels or to
    dense_attention reads shapes, dtypes and options only, so it runs on
    CPU tensors; a ragged L (40) is the kernels'."""
    q = torch.zeros(2, 40, 4, d, dtype=dtype)
    k = torch.zeros(2, 40, 2, d, dtype=kv_dtype or dtype)
    seg_ids = torch.zeros(2, 40, dtype=torch.long) if seg else None
    assert tattn.kernel_takes(q, k, k, seg_ids) is takes


@pytest.mark.parametrize("d", [16, 64])
def test_cpu_calls_are_no_dense_routes(monkeypatch, d):
    """On the CPU the plain versions run whatever the shape: only a CUDA
    call that the kernels decline counts as a dense route. The result is
    JAX's flash_attention's (dense off the TPU)."""
    monkeypatch.setattr(tattn, "dense_routes", 0)
    q, k, v = _qkv(6, lq=24, lk=24, hkv=2, d=d)
    seg = np.repeat(np.arange(3), 8)[None].repeat(B, 0)
    for ids in (None, seg):
        want = jattn.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            segment_ids=None if ids is None else jnp.asarray(ids))
        got = tattn.flash_attention(
            *map(torch.from_numpy, (q, k, v)), causal=True,
            segment_ids=None if ids is None else torch.from_numpy(ids))
        _close(got, want)
    assert tattn.dense_routes == 0


def test_plain_flash_rejects_causal_with_unequal_lengths():
    q, k, v = _qkv(4, lq=8, lk=16)
    with pytest.raises(ValueError, match="Lq == Lk"):
        tattn.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)


def test_cpu_tensors_never_launch_the_kernel(monkeypatch):
    monkeypatch.setattr(tattn, "launches", 0)
    monkeypatch.setattr(tattn, "_load",
                        lambda name: pytest.fail("kernel load"))
    q, k, v = _qkv(5, lq=16, lk=16)
    tattn.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    assert tattn.launches == 0


def test_build_key_follows_every_header(tmp_path):
    """A library's build key covers its .cu and every csrc header, so an
    edit to a header any kernel includes (flash_tc.cuh, or the backward's
    flash_tc_bwd.cuh) rebuilds it; no nvcc is needed to compute it."""
    for src in (REPO / "ray_tpu_torch" / "csrc").iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    key = {n: tattn.source_digest(n, tmp_path) for n in tattn.KERNELS}
    assert key == {n: tattn.source_digest(n) for n in tattn.KERNELS}
    for header in ("flash_tc.cuh", "flash_tc_bwd.cuh", "flash_common.cuh"):
        path = tmp_path / header
        path.write_bytes(path.read_bytes() + b"\n// edited\n")
        edited = {n: tattn.source_digest(n, tmp_path) for n in tattn.KERNELS}
        assert all(edited[n] != key[n] for n in tattn.KERNELS), header
        key = edited
    (tmp_path / "flash_new.cuh").write_text("#pragma once\n")
    assert tattn.source_digest("flash_fwd", tmp_path) != key["flash_fwd"]
    # a kernel's own source moves its key alone
    key = {n: tattn.source_digest(n, tmp_path) for n in tattn.KERNELS}
    path = tmp_path / "flash_stats.cu"
    path.write_bytes(path.read_bytes() + b"\n")
    assert {n: tattn.source_digest(n, tmp_path) for n in tattn.KERNELS} == \
        dict(key, flash_stats=tattn.source_digest("flash_stats", tmp_path))
    assert tattn.source_digest("flash_stats", tmp_path) != key["flash_stats"]


def test_bf16_kernels_take_only_rows_on_16_byte_boundaries():
    """The bf16 kernels copy rows in 16-byte chunks: a view whose base or
    (batch, seq, head) stride is off a 16-byte boundary raises, and the
    layouts the main paths pass (contiguous, a slice of heads or
    positions, a head dim cut from a wider one of 8k elements) do not."""
    x = torch.zeros(2, 64, 8, 128, dtype=torch.bfloat16)
    for ok in (x, x[:, 16:], x[:, :, 2:6], x[..., :64], x[:, :1, :, 8:72]):
        tattn._check_rows_aligned(q=ok)
    narrow = torch.zeros(2, 64, 8, 100, dtype=torch.bfloat16)[..., :64]
    for bad in (x[..., 1:65], narrow):  # base 2 bytes in; head step 200
        with pytest.raises(ValueError, match="16-byte"):
            tattn._check_rows_aligned(k=bad)
    # an axis of extent 1 is never stepped over: its stride is free
    tattn._check_rows_aligned(v=x[:1, :1].as_strided((1, 1, 8, 64),
                                                     (3, 5, 128, 1)))


def _bwd_args(dtype=torch.bfloat16, B=2, L=64, H=4, Hkv=2, D=64):
    q = torch.zeros(B, L, H, D, dtype=dtype)
    k, v = (torch.zeros(B, L, Hkv, D, dtype=dtype) for _ in range(2))
    lse = torch.zeros(B, H, L)
    return q, k, v, torch.zeros_like(q), lse, torch.ones_like(q)


def test_bwd_inputs_are_checked_and_prepared_on_the_cpu():
    """The backward wrapper's checks run on any device: dO and o must match
    q, lse must be contiguous fp32 [B, H, Lq], bf16 q, k and v must have
    rows on 16-byte boundaries; a dO whose rows are off them, or whose head
    dim is strided, comes back as a contiguous copy, an aligned one as it
    is."""
    q, k, v, o, lse, do = _bwd_args()
    assert tattn._bwd_inputs(q, k, v, o, lse, do) is do
    bad = {"dO shape": dict(do=do[:, :32]), "dO dtype": dict(do=do.float()),
           "o shape": dict(o=o[:1]), "lse shape": dict(lse=lse[:, :2]),
           "lse dtype": dict(lse=lse.double()),
           "lse layout": dict(lse=lse.transpose(1, 2).contiguous()
                              .transpose(1, 2))}
    for what, change in bad.items():
        args = dict(dict(q=q, k=k, v=v, o=o, lse=lse, do=do), **change)
        with pytest.raises(ValueError, match="must"):
            tattn._bwd_inputs(**args)
    wide = torch.zeros(2, 64, 4, 100, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        tattn._bwd_inputs(wide[..., :64], k, v, o, lse, do)
    for odd in (torch.ones(2, 64, 4, 65, dtype=torch.bfloat16)[..., 1:],
                torch.ones(2, 64, 64, 4, dtype=torch.bfloat16)
                .transpose(2, 3)):
        got = tattn._bwd_inputs(q, k, v, o, lse, odd)
        assert got is not odd and got.is_contiguous()
        assert tattn._rows_aligned(got) and torch.equal(got, odd)
    # fp32 rows are read element by element: only a strided head dim is
    # copied
    q, k, v, o, lse, do = _bwd_args(torch.float32)
    off = torch.ones(2, 64, 4, 65)[..., 1:]
    assert tattn._bwd_inputs(q, k, v, o, lse, off) is off


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_di_is_the_fp32_row_dot_and_leaves_o_alone(dtype):
    """di = rowsum(o * dO) in fp32, [B, H, L] contiguous, bit for bit the
    product of two fp32 copies; o is not written (for fp32, o.float() is
    o itself)."""
    g = torch.Generator().manual_seed(9)
    o, do = (torch.randn(2, 40, 4, 64, generator=g).to(dtype)
             for _ in range(2))
    keep = o.clone()
    got = tattn.bwd_di(o, do)
    want = (o.float() * do.float()).sum(-1).transpose(1, 2)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want) and torch.equal(o, keep)


def test_bwd_launch_checks_inputs_before_loading_a_kernel(monkeypatch):
    """A bad dO, lse or bf16 row raises before any kernel library is
    loaded (the device check is bypassed to run on the CPU)."""
    monkeypatch.setattr(tattn, "_check", lambda *a: None)
    monkeypatch.setattr(tattn, "_load",
                        lambda name: pytest.fail("kernel load"))
    q, k, v, o, lse, do = _bwd_args()
    with pytest.raises(ValueError, match="dO must match"):
        tattn._launch_bwd(q, k, v, o, lse, do[:, :8], True, 0.125)
    with pytest.raises(ValueError, match="lse"):
        tattn._launch_bwd(q, k, v, o, lse.double(), do, True, 0.125)
    off_k = torch.zeros(2, 64, 2, 72, dtype=torch.bfloat16)[..., 1:65]
    with pytest.raises(ValueError, match="16-byte"):
        tattn._launch_bwd(q, off_k, v, o, lse, do, True, 0.125)


# -------------------------------------------------- package boundaries

_FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "optax", "ray_tpu")


def _port_sources():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


def test_port_sources_import_no_jax_and_no_ray_tpu():
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    # the training slice's loss, the code that builds and loads the .cu
    # kernels, the sequence-parallel modules and the pipeline's are
    # covered like the rest
    assert {"ray_tpu_torch/ops/chunked_xent.py",
            "ray_tpu_torch/ops/attention.py",
            "ray_tpu_torch/parallel/ring_attention.py",
            "ray_tpu_torch/parallel/ulysses.py",
            "ray_tpu_torch/parallel/pipeline.py",
            "ray_tpu_torch/parallel/mpmd_pipeline.py",
            "ray_tpu_torch/serve/deployment.py",
            "ray_tpu_torch/serve/controller.py",
            "ray_tpu_torch/serve/proxy.py",
            "ray_tpu_torch/serve/config_file.py",
            "ray_tpu_torch/util/pubsub.py",
            "ray_tpu_torch/_private/usage.py",
            "ray_tpu_torch/dag/__init__.py",
            "ray_tpu_torch/dag/compiled.py",
            "ray_tpu_torch/util/collective.py",
            "ray_tpu_torch/util/chaos.py",
            "ray_tpu_torch/util/invariants.py",
            "ray_tpu_torch/cluster_utils.py",
            "ray_tpu_torch/tune/__init__.py",
            "ray_tpu_torch/tune/tuner.py",
            "ray_tpu_torch/tune/trainable.py",
            "ray_tpu_torch/tune/external.py",
            "ray_tpu_torch/tune/integrations.py",
            "ray_tpu_torch/workflow/__init__.py",
            "ray_tpu_torch/runtime_env/runtime_env.py",
            "ray_tpu_torch/runtime_env/pip_env.py",
            "ray_tpu_torch/runtime_env/conda_env.py",
            "ray_tpu_torch/runtime_env/container.py",
            "ray_tpu_torch/job.py",
            "ray_tpu_torch/dashboard/head.py",
            "ray_tpu_torch/scripts.py",
            "ray_tpu_torch/__main__.py",
            "ray_tpu_torch/cross_language.py",
            "ray_tpu_torch/util/actor_pool.py",
            "ray_tpu_torch/util/queue.py",
            "ray_tpu_torch/util/multiprocessing.py",
            "ray_tpu_torch/util/joblib.py",
            "ray_tpu_torch/util/check_serialize.py",
            "ray_tpu_torch/util/slo.py",
            "ray_tpu_torch/util/accelerators.py",
            "ray_tpu_torch/testing/mocks.py",
            "ray_tpu_torch/autoscaler/autoscaler.py",
            "ray_tpu_torch/autoscaler/node_provider.py",
            "ray_tpu_torch/autoscaler/gcp.py",
            "ray_tpu_torch/autoscaler/launcher.py",
            "ray_tpu_torch/autoscaler/testing.py"} <= names
    # the RL slice's fifteen modules
    assert {f"ray_tpu_torch/rl/{m}.py" for m in (
        "__init__", "vtrace", "rl_module", "ppo_loss", "learner",
        "mesh_learner", "pixel_env", "env_runner", "connectors", "replay",
        "algorithm", "impala", "appo", "multi_agent", "podracer")} <= names
    assert len(_port_sources()) > 10
    assert not bad, bad


# A name of the JAX package (or JAX) in a string the port runs or spawns,
# as ``ray_tpu``'s runtime names its worker, head and zygote entry points
# in bootstrap sources (``ray_tpu/_private/node.py:141-172``). Docstrings
# are prose and are not read.
_SPAWNED_NAME = re.compile(
    r"(?<![\w/.])(?:ray_tpu|jax|jaxlib|ml_dtypes)\.[A-Za-z_]"
    r"|\b(?:import|from)\s+(?:ray_tpu|jax|jaxlib|ml_dtypes)\b(?!_)")


def _string_constants(tree):
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node


def _spawned_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return [f"{path.name}:{n.lineno}: {m.group(0)}"
            for n in _string_constants(tree)
            for m in [_SPAWNED_NAME.search(n.value)] if m]


def test_port_strings_name_no_ray_tpu_or_jax_module():
    """String constants in the port (bootstrap sources, lazy imports by
    name) name no module of the JAX package, JAX or ml_dtypes; the scan
    finds the reference runtime's own bootstrap strings."""
    assert len(_spawned_names(REPO / "ray_tpu/_private/node.py")) >= 4
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    assert {"ray_tpu_torch/_private/node.py",
            "ray_tpu_torch/_private/worker_main.py",
            "ray_tpu_torch/_private/gcs.py",
            "ray_tpu_torch/train/trainer.py",
            "ray_tpu_torch/serve/deployment.py",
            "ray_tpu_torch/serve/controller.py",
            "ray_tpu_torch/dag/compiled.py",
            "ray_tpu_torch/util/collective.py",
            "ray_tpu_torch/cluster_utils.py",
            "ray_tpu_torch/tune/tuner.py",
            "ray_tpu_torch/tune/trainable.py",
            "ray_tpu_torch/workflow/__init__.py",
            "ray_tpu_torch/runtime_env/container.py",
            "ray_tpu_torch/job.py",
            "ray_tpu_torch/scripts.py",
            "ray_tpu_torch/autoscaler/node_provider.py",
            "ray_tpu_torch/autoscaler/launcher.py",
            "ray_tpu_torch/rl/podracer.py",
            "ray_tpu_torch/rl/env_runner.py"} <= names
    bad = [hit for path in _port_sources() for hit in _spawned_names(path)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax_and_no_ray_tpu():
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.ops, ray_tpu_torch.models\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.util.events\n"
        "import ray_tpu_torch.ops.chunked_xent, ray_tpu_torch.models.convert\n"
        "import ray_tpu_torch.parallel, ray_tpu_torch.parallel.pipeline\n"
        "import ray_tpu_torch.parallel.mpmd_pipeline\n"
        "import ray_tpu_torch.train, ray_tpu_torch.util\n"
        "import ray_tpu_torch._private.gcs, ray_tpu_torch._private.node\n"
        "import ray_tpu_torch._private.worker_main\n"
        "import ray_tpu_torch.serve.deployment, ray_tpu_torch.serve.proxy\n"
        "import ray_tpu_torch.serve.controller, ray_tpu_torch.serve.ingress\n"
        "import ray_tpu_torch.serve.batching, ray_tpu_torch.serve.multiplex\n"
        "import ray_tpu_torch.serve.rpc_client\n"
        "import ray_tpu_torch.serve.config_file, ray_tpu_torch.serve.llm\n"
        "import ray_tpu_torch.util.pubsub, ray_tpu_torch._private.usage\n"
        "import ray_tpu_torch.data, ray_tpu_torch.data.preprocessors\n"
        "import ray_tpu_torch.train.torch, ray_tpu_torch.train.huggingface\n"
        "import ray_tpu_torch.dag, ray_tpu_torch.dag.compiled\n"
        "import ray_tpu_torch.util.collective, ray_tpu_torch.util.chaos\n"
        "import ray_tpu_torch.util.invariants, ray_tpu_torch.cluster_utils\n"
        "import ray_tpu_torch.tune, ray_tpu_torch.tune.tuner\n"
        "import ray_tpu_torch.tune.external, ray_tpu_torch.workflow\n"
        "import ray_tpu_torch.runtime_env, ray_tpu_torch.runtime_env.pip_env\n"
        "import ray_tpu_torch.runtime_env.conda_env\n"
        "import ray_tpu_torch.runtime_env.container, ray_tpu_torch.job\n"
        "import ray_tpu_torch.dashboard, ray_tpu_torch.dashboard.grafana\n"
        "import ray_tpu_torch.dashboard.ui, ray_tpu_torch.scripts\n"
        "import ray_tpu_torch.cross_language, ray_tpu_torch.testing\n"
        "import ray_tpu_torch.autoscaler.gcp\n"
        "import ray_tpu_torch.autoscaler.launcher\n"
        "import ray_tpu_torch.util.actor_pool, ray_tpu_torch.util.queue\n"
        "import ray_tpu_torch.util.multiprocessing\n"
        "import ray_tpu_torch.util.joblib, ray_tpu_torch.util.slo\n"
        "import ray_tpu_torch.util.check_serialize\n"
        "import ray_tpu_torch.util.accelerators\n"
        "import ray_tpu_torch.rl, ray_tpu_torch.rl.podracer\n"
        "import ray_tpu_torch.rl.multi_agent, ray_tpu_torch.rl.appo\n"
        "# the HTTP proxy and the dashboard import aiohttp only when they\n"
        "# start, data loads\n"
        "# Arrow and pandas only at its edges, train.huggingface loads\n"
        "# transformers only for an HF Trainer, and tune its searchers'\n"
        "# and loggers' packages only when they are built; util.joblib\n"
        "# loads joblib, and the launcher yaml, only when used\n"
        "for m in ('aiohttp', 'pyarrow', 'pandas', 'transformers',\n"
        "          'optuna', 'hyperopt', 'mlflow', 'wandb', 'joblib',\n"
        "          'yaml'):\n"
        "    assert m not in sys.modules, m\n"
        "from ray_tpu_torch.ops import attention\n"
        "assert attention.KERNELS == ('flash_fwd', 'flash_bwd', "
        "'flash_stats')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_rl_builds_a_catch_podracer_without_gymnasium():
    """With gymnasium hidden, ``ray_tpu_torch.rl`` imports, CatchEnv
    carries plain spaces, and a Podracer config over it probes them to
    the ViT pixel module (no cluster is started)."""
    code = (
        "import sys, types\n"
        "sys.modules['gymnasium'] = None\n"
        "import ray_tpu_torch.rl as rl\n"
        "from ray_tpu_torch.rl.podracer import Podracer\n"
        "cfg = (rl.PodracerConfig()\n"
        "       .environment('catch', env_fn=lambda: rl.CatchEnv(64))\n"
        "       .training(pixel_model={'patch_size': 16, 'd_model': 768,\n"
        "                              'n_layers': 12, 'n_heads': 12,\n"
        "                              'd_ff': 3072})\n"
        "       .learners(use_gpu=True))\n"
        "pod = types.SimpleNamespace(config=cfg)\n"
        "probe = Podracer._probe_env_spaces(pod)\n"
        "assert probe == {'shape': (64, 64, 1), 'num_actions': 3,\n"
        "                 'obs_dim': 4096}, probe\n"
        "m = rl.PixelModuleConfig(image_size=64, channels=1,\n"
        "                         num_actions=3, **cfg.pixel_model)\n"
        "assert m.vit.head_dim == 64 and m.vit.num_patches == 16\n"
        "assert rl.CatchEnv.__mro__[1] is object\n"
        "space = rl.CatchEnv(8).action_space\n"
        "assert type(space).__module__ == 'ray_tpu_torch.rl.pixel_env'\n"
        "assert 'gymnasium' not in [k for k, v in sys.modules.items()\n"
        "                           if v is not None]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_event_buffer_is_bounded_and_drains(monkeypatch):
    from ray_tpu_torch.util import events

    events.reset()
    monkeypatch.setattr(events, "_cap", 2)
    for i in range(3):
        events.emit("serve.req.queue", plane="serve", rid=str(i))
    events.emit("serve.req.first_token", plane="serve", dur=0.5)
    rows, dropped = events.drain()
    assert [r[1] for r in rows] == ["serve.req.queue"] * 2
    assert rows[0][6] == {"rid": "0"}
    assert dropped == {"serve": 2}
    assert events.drain() == ([], {})


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ray_tpu_torch.models import (LLAMA_DEBUG, GenerationEngine,
                                      init_params, params_from_numpy)
    from ray_tpu_torch.serve import LLMServer

    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(LLAMA_DEBUG, g)
    params = init_params(LLAMA_DEBUG, g, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(params, LLAMA_DEBUG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMServer(lambda: (params, LLAMA_DEBUG))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"norm": np.zeros(4, np.float32)})
