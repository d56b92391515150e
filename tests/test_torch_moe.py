"""Parity of the PyTorch port's dense MoE (``parallel/moe.py``) with the
JAX package's, on the CPU in fp32: the router, the top-k gates (ties
included), the load-balance loss, the dense all-experts FFN and its
gradients, the capacity and the capacity assignment.

Inputs come from numpy with a seed. Both sides compute in fp32 and differ
only in the order of their sums, so values are held at rtol 1e-5 and atol
1e-6 and gradients, which pass through more sums, at rtol 1e-4 and atol
2e-5. The expert-parallel path runs in the gloo group of
``tests/test_torch_parallel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel import moe as jmoe
from ray_tpu_torch.parallel import moe as tmoe

VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
B, L, D, F, E = 2, 12, 32, 48, 4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=randn(B, L, D), router=randn(D, E, scale=0.5),
                w_gate=randn(E, D, F, scale=D ** -0.5),
                w_up=randn(E, D, F, scale=D ** -0.5),
                w_down=randn(E, F, D, scale=F ** -0.5),
                cot=randn(B, L, D))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def test_router_and_gates_match_jax():
    a = _inputs(1)
    probs_j = jmoe.router_probs(jnp.asarray(a["x"]), jnp.asarray(a["router"]))
    probs_t = tmoe.router_probs(torch.from_numpy(a["x"]),
                                torch.from_numpy(a["router"]))
    assert probs_t.dtype == torch.float32
    _close(probs_t, probs_j, VALUE_TOL)
    for k in (1, 2, 3):
        vj, ij = jmoe.top_k_gates(probs_j, k)
        vt, it = tmoe.top_k_gates(probs_t, k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        _close(vt, vj, VALUE_TOL)


def test_tied_gates_take_the_lower_index_first_as_lax_top_k():
    """Equal probabilities (a uniform router, and pairs of ties) give
    JAX's order: the lower expert index first."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2], [0.0, 0.5, 0.0, 0.5]],
                     np.float32)
    for k in (1, 2, 3):
        _, ij = jmoe.top_k_gates(jnp.asarray(probs), k)
        _, it = tmoe.top_k_gates(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_load_balance_loss_counts_top1_assignments_as_jax():
    a = _inputs(2)
    probs = jmoe.router_probs(jnp.asarray(a["x"]), jnp.asarray(a["router"]))
    _, idx = jmoe.top_k_gates(probs, 2)
    want = jmoe.load_balance_loss(probs, idx, E)
    got = tmoe.load_balance_loss(torch.from_numpy(np.array(probs)),
                                 torch.from_numpy(np.array(idx)).long(), E)
    _close(got, want, VALUE_TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_dense_moe_and_gradients_match_jax(k):
    """Output, aux, and the gradients of sum(out * cot) + aux for x, the
    router and every expert leaf against jax.grad."""
    a = _inputs(3 + k)
    names = ("x", "router", "w_gate", "w_up", "w_down")

    def jloss(x, router, w_gate, w_up, w_down):
        out, aux = jmoe.moe_ffn_dense(
            x, router, {"w_gate": w_gate, "w_up": w_up, "w_down": w_down}, k)
        return (out * jnp.asarray(a["cot"])).sum() + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
            *(jnp.asarray(a[n]) for n in names))
    ts = {n: torch.from_numpy(a[n]).requires_grad_() for n in names}
    out, aux = tmoe.moe_ffn_dense(
        ts["x"], ts["router"],
        {n: ts[n] for n in ("w_gate", "w_up", "w_down")}, k)
    ((out * torch.from_numpy(a["cot"])).sum() + aux).backward()
    _close(out, jout, VALUE_TOL)
    _close(aux, jaux, VALUE_TOL)
    for n, g in zip(names, jgrads):
        np.testing.assert_allclose(ts[n].grad.numpy(), np.asarray(g),
                                   **GRAD_TOL, err_msg=n)


def test_dense_moe_rounds_the_gates_to_the_experts_dtype():
    """In a bf16 model the gates are cast to bf16 before the combining
    product, as JAX casts them: the output equals the experts' outputs
    weighted by the bf16 gates."""
    a = _inputs(6)
    x = torch.from_numpy(a["x"]).bfloat16()
    experts = {n: torch.from_numpy(a[n]).bfloat16()
               for n in ("w_gate", "w_up", "w_down")}
    router = torch.from_numpy(a["router"])
    out, _ = tmoe.moe_ffn_dense(x, router, experts, 2)
    probs = tmoe.router_probs(x, router)
    vals, idx = tmoe.top_k_gates(probs, 2)
    gates = torch.zeros(B, L, E).scatter(-1, idx, vals).bfloat16()
    y = tmoe._expert_ffn(x.reshape(1, B * L, D).expand(E, B * L, D),
                         experts).float()
    want = torch.einsum("te,etd->td", gates.reshape(B * L, E).float(),
                        y).reshape(B, L, D)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want.numpy(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("args", [(16, 8, 2, 2.0), (1, 64, 1, 1.0),
                                  (2048, 8, 2, 4.0), (32, 4, 2, 0.1),
                                  (100, 6, 3, 1.25), (7, 3, 2, 0.5)])
def test_default_capacity_matches_jax(args):
    assert tmoe.default_capacity(*args) == jmoe.default_capacity(*args)


def _jax_dispatch(gate_idx, n_experts, capacity):
    """The capacity assignment of JAX's ``ep_moe_ffn`` (moe.py:125-136),
    as its one-hot dispatch tensor [T, E, C]."""
    mask = np.eye(n_experts, dtype=np.float32)[gate_idx]       # [T, k, E]
    counts = np.zeros(n_experts, np.float32)
    dispatch = np.zeros((gate_idx.shape[0], n_experts, capacity), np.float32)
    for j in range(gate_idx.shape[1]):
        m = mask[:, j]
        pos = np.cumsum(m, axis=0) - 1 + counts[None]
        counts = counts + m.sum(0)
        keep = m * (pos < capacity)
        slot = (pos * m).sum(-1).astype(np.int32)
        onehot = np.zeros((len(slot), capacity), np.float32)
        ok = slot < capacity
        onehot[ok, slot[ok]] = 1
        dispatch += keep[:, :, None] * onehot[:, None, :]
    return dispatch


@pytest.mark.parametrize("capacity", [1, 3, 8, 40])
def test_capacity_slots_drop_what_jax_drops(capacity):
    """Each kept (token, slot) lands in the row JAX's dispatch puts it in,
    earlier gate slots first, then token order; the rest are dropped."""
    rng = np.random.default_rng(capacity)
    T, k = 40, 2
    gate_idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    slots = tmoe.capacity_slots(torch.from_numpy(gate_idx), E,
                                capacity).numpy()
    got = np.zeros((T, E * capacity + 1), np.float32)
    for t in range(T):
        for j in range(k):
            got[t, slots[t, j]] += 1
    want = _jax_dispatch(gate_idx, E, capacity).reshape(T, E * capacity)
    np.testing.assert_array_equal(got[:, :-1], want)
    assert (got[:, -1] == k - want.sum(1)).all()
