"""Speculative decoding: a small draft model proposes k tokens, the
target verifies them in one forward pass.

Port of ``ray_tpu/models/speculative.py``. Greedy verification makes the
output exactly the target's greedy decode; the draft changes only how many
target forwards it takes. A round drafts k tokens with ``_decode_step``,
runs one target ``_decode_step`` over ``[next, d1..dk]``, takes the accept
length as the ``cumprod`` of the matches, and writes the accepted drafts
and the target's correction into a device buffer with k + 1 slack. A
rejected draft costs nothing to roll back: its K/V stay in the caches,
masked by position until overwritten.

The JAX program is one ``jit`` whose loop runs on the device, with one
host fetch per generation. Eager PyTorch cannot leave a data-dependent
loop without reading its condition, so this port reads one scalar a round,
the output count (which also says whether the draft cache needs the
full-acceptance feed), and the tokens once at the end: every read goes
through ``_device_fetch``, and ``stats["host_fetches"]`` is their count,
rounds + 1.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .llama import LlamaConfig, _decode_step, _prefill


def _device_fetch(t: torch.Tensor) -> torch.Tensor:
    """Every read of the device by the speculative loop goes through this
    module-level seam, so a caller can count the reads (and forbid all
    others)."""
    return t.cpu()


def truncated_draft(params, cfg: LlamaConfig, n_layers: int):
    """A draft made of the target's first ``n_layers`` layers and its
    embedding, final norm and head: ``(draft_params, draft_cfg)``. It
    shares the target's tensors and token space and costs
    ``n_layers / cfg.n_layers`` of a target forward."""
    if not 0 < n_layers < cfg.n_layers:
        raise ValueError(
            f"draft needs 1..{cfg.n_layers - 1} layers, got {n_layers}")
    draft_cfg = dataclasses.replace(cfg, n_layers=n_layers)
    draft_params = dict(params)
    draft_params["layers"] = list(params["layers"][:n_layers])
    return draft_params, draft_cfg


@torch.no_grad()
def _spec_decode(params, dparams, prompt: torch.Tensor, cfg: LlamaConfig,
                 dcfg: LlamaConfig, k: int, max_new: int):
    """Speculative generation of ``max_new`` tokens after ``prompt``
    [1, L]. Returns the tokens (on the host), the rounds, the accepted
    drafts and the number of ``_device_fetch`` reads."""
    room = max_new + k + 1
    t_logits, t_caches, L, cos, sin = _prefill(params, prompt, cfg, room)
    _, d_caches, _, dcos, dsin = _prefill(dparams, prompt, dcfg, room)
    nxt = t_logits[:, -1].argmax(dim=-1)                       # [1]
    # The output buffer has k + 1 slack, so every round writes a whole
    # window; a window's unaccepted tail is overwritten by the next one.
    buf = torch.zeros(max_new + k + 1, dtype=torch.long,
                      device=prompt.device)
    buf[:1] = nxt
    n_out_dev = torch.ones((), dtype=torch.long, device=prompt.device)
    steps = torch.arange(k + 1, device=prompt.device)
    n_out, pos, rounds, accepted, fetches = 1, L, 0, 0, 0
    while n_out < max_new:
        tok, drafts = nxt, []
        for i in range(k):
            logits, d_caches = _decode_step(dparams, tok[:, None], d_caches,
                                            pos + i, dcfg, dcos, dsin)
            tok = logits[:, -1].argmax(dim=-1)
            drafts.append(tok)
        draft = torch.stack(drafts, dim=1)                     # [1, k]
        logits, t_caches = _decode_step(
            params, torch.cat([nxt[:, None], draft], dim=1), t_caches, pos,
            cfg, cos, sin)
        targets = logits[0].argmax(dim=-1)                     # [k + 1]
        # The longest draft prefix that matches the target's own choices.
        n_acc = torch.cumprod((draft[0] == targets[:k]).long(), 0).sum()
        corr = targets.gather(0, n_acc.reshape(1))  # no host read
        emit = torch.where(steps == n_acc, corr,
                           torch.cat([draft[0], corr]))
        buf[n_out:n_out + k + 1] = emit
        n_out_dev = n_out_dev + 1 + n_acc
        new_out = int(_device_fetch(n_out_dev))
        fetches += 1
        n_acc_host = new_out - n_out - 1
        if n_acc_host == k:
            # Every draft was accepted: d_k was emitted but never fed to
            # the draft, which would leave a hole at pos + k.
            _, d_caches = _decode_step(dparams, draft[:, k - 1:], d_caches,
                                       pos + k, dcfg, dcos, dsin)
        nxt = corr
        pos += 1 + n_acc_host
        n_out = new_out
        rounds += 1
        accepted += n_acc_host
    tokens = _device_fetch(buf[:max_new])
    return tokens, rounds, accepted, fetches + 1


def generate_speculative(params, draft_params, prompt: torch.Tensor,
                         cfg: LlamaConfig, draft_cfg: LlamaConfig,
                         max_new: int = 32, k: int = 4
                         ) -> Tuple[torch.Tensor, dict]:
    """Greedy speculative decode, batch 1: returns (tokens [1, max_new] on
    the host, stats). The tokens are ``generate_greedy``'s on the target.
    Each round costs one target forward over k + 1 positions and k draft
    forwards; acceptance varies per sequence, which is why this is batch 1
    (batching composes at the serving layer)."""
    if prompt.shape[0] != 1:
        raise ValueError("generate_speculative is batch-1; batch "
                         "requests compose at the serving layer")
    k, max_new = int(k), int(max_new)
    toks, rounds, accepted, fetches = _spec_decode(
        params, draft_params, prompt, cfg, draft_cfg, k, max_new)
    stats = {
        "rounds": rounds,
        "drafted": rounds * k,
        "accepted": accepted,
        "acceptance_rate": accepted / max(rounds * k, 1),
        "target_forwards": rounds + 1,  # +1 prefill
        "tokens_per_target_forward": max_new / max(rounds + 1, 1),
        "host_fetches": fetches,
    }
    return toks.to(prompt.dtype)[None, :], stats
