"""How a run's ``correct`` is decided: the greedy tokens the timed path
served, held against the plain reference (``reference.py``).

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed and always holding the longest
one, is run through the reference over its prompt and served tokens. At
each served position the reference's logits say how far the served
token's logit lies below the best one there (0 where the served token is
the reference's choice). Two numbers of those gaps are compared with the
limits in the configuration's file (``correct``): the widest gap
(``max_gap``) and the mean gap (``mean_gap``); a limit given as null is
not compared. Greedy decoding in bf16 may take a near-tie the other way,
or route a token to another expert where two are near a tie, which reads
as a small gap; a token the program got wrong reads as a large one, and
a program that drifts everywhere raises the mean.

The control (``control_gaps``) puts the reference, computed in fp8, in
the program's place: at each position of the same sequences, the gap of
the token that fp8 ranks first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from bench import reference as ref

NUMBERS = ("max_gap", "mean_gap")


def pick_sample(finished: Sequence[Dict], seed: int, k: int) -> List[Dict]:
    """``k`` finished requests: the one with the most served tokens (the
    lowest index on a tie), and the rest drawn from the seed."""
    if not finished:
        return []
    order = sorted(finished, key=lambda r: (-len(r["tokens"]), r["idx"]))
    rest = order[1:]
    rng = np.random.default_rng((seed ^ 0xC0FFEE) & 0xFFFFFFFF)
    pick = [rest[i] for i in rng.permutation(len(rest))[: k - 1]]
    return [order[0]] + sorted(pick, key=lambda r: r["idx"])


def _seqs(sample: Sequence[Dict], ranks: Sequence[int]) -> List[Dict]:
    """Each sampled request as the reference's sequence: its prompt and
    every served token but the last; deltas from the last prompt token."""
    out = []
    for r in sample:
        prompt = np.asarray(r["prompt"], np.int64)
        toks = np.concatenate([prompt, np.asarray(r["tokens"][:-1],
                                                  np.int64)])
        out.append({"tokens": toks, "adapter": r["adapter"],
                    "rank": ranks[r["adapter"]],
                    "lora_from": len(prompt) - 1})
    return out


def _served(W, adapters, m, sample, ranks, precision, block=4):
    """Per sampled request: (logits (n_served, vocab) at its served
    positions, the least router margin over the layers at each), computed
    ``block`` requests at a time."""
    seqs = _seqs(sample, ranks)
    out = []
    for i in range(0, len(seqs), block):
        part = seqs[i:i + block]
        margins: List[torch.Tensor] = []
        hs = ref.forward_hidden(W, adapters, m, part, precision, margins)
        least = torch.stack(margins).min(dim=0).values if margins else None
        o = 0
        for s, h in zip(part, hs):
            n = h.shape[0]
            lo = s["lora_from"]
            mg = least[o + lo:o + n] if least is not None else None
            out.append((ref.logits(W, m, h[lo:], precision), mg))
            o += n
        del hs
    return out


def _summary(sample, gaps: List[torch.Tensor], margins: List) -> Dict:
    if not gaps:
        return {"max_gap": float("inf"), "mean_gap": float("inf"),
                "median_gap": float("inf"), "mismatch": 1.0, "tokens": 0,
                "worst": []}
    g = torch.cat(gaps)
    # each served token's position in its sequence, and its request
    pos = torch.cat([torch.arange(len(r["tokens"])) + len(r["prompt"]) - 1
                     for r in sample])
    req = torch.cat([torch.full((len(r["tokens"]),), r["idx"])
                     for r in sample])
    out = {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
           "median_gap": float(g.median()),
           "mismatch": float((g > 0).float().mean()), "tokens": int(g.numel())}
    edges = (0, 256, 512, 1024, 1 << 30)
    out["mismatch_by_position"] = [
        [lo, float((g[(pos >= lo) & (pos < hi)] > 0).float().mean())
         if bool(((pos >= lo) & (pos < hi)).any()) else None]
        for lo, hi in zip(edges[:-1], edges[1:])]
    top = torch.argsort(g, descending=True)[:5]
    mg = torch.cat(margins) if all(m is not None for m in margins) else None
    # the five widest: gap, least router margin, position, request
    out["worst"] = [[float(g[i]), float(mg[i]) if mg is not None else None,
                     int(pos[i]), int(req[i])] for i in top]
    if mg is not None:
        out["router_margin_median"] = float(mg.median())
    return out


def served_gaps(W, adapters, m, sample, ranks) -> Dict:
    """The served tokens' gaps below the reference's best logit, over the
    sample: widest, mean, median, the share not the reference's choice,
    the count, and the five widest beside their least router margin."""
    gaps, margins = [], []
    with torch.no_grad(), ref.reference_mode():
        for r, (lg, mg) in zip(sample, _served(W, adapters, m, sample,
                                                ranks, "f32")):
            tok = torch.as_tensor(r["tokens"], device=lg.device)
            best = lg.max(dim=-1).values
            gaps.append((best - lg.gather(1, tok[:, None])[:, 0]).cpu())
            margins.append(mg.cpu() if mg is not None else None)
    return _summary(sample, gaps, margins)


def control_gaps(W, adapters, m, sample, ranks, precision: str = "fp8"
                 ) -> Dict:
    """The control's reading on the same sequences: at each served
    position, the f32 reference's gap of the token that the reference in
    ``precision`` (fp8: the control; bf16: a witness) puts first."""
    gaps, margins = [], []
    with torch.no_grad(), ref.reference_mode():
        f32 = _served(W, adapters, m, sample, ranks, "f32")
        fp8 = _served(W, adapters, m, sample, ranks, precision)
        for (a, mg), (b, _) in zip(f32, fp8):
            top = b.argmax(dim=-1)
            gaps.append((a.max(dim=-1).values
                         - a.gather(1, top[:, None])[:, 0]).cpu())
            margins.append(mg.cpu() if mg is not None else None)
    return _summary(sample, gaps, margins)


def checks(gaps: Dict, limits: Dict, min_tokens: int) -> Dict:
    """The numbers compared, each with its limit (the token count's is a
    least count)."""
    out = {f"served_logit_{k}": {"value": gaps[k], "limit": float(limits[k])}
           for k in NUMBERS if limits.get(k) is not None}
    out["served_tokens_compared"] = {"value": gaps["tokens"],
                                     "limit": min_tokens}
    return out


def passed(c: Dict) -> bool:
    return all((v["value"] >= v["limit"]) if k == "served_tokens_compared"
               else (v["value"] <= v["limit"]) for k, v in c.items())
