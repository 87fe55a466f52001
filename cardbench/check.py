"""The comparison that decides `correct`: what the timed path produced,
held to the plain reference that the cell's configuration names
(`cardbench/reference/<name>.py`) by the numbers and limits of
`cardbench/limits/<cell>.json`.

Training (the readings of `drivers/train.py`, the reference's three
steps from the same weights and rows):
- `loss_gap`: the largest |program - reference| / |reference| of the
  three steps' losses (shown by `calibrate.py`; compared only where a
  limits file names it);
- `grad_gap`: the worst leaf's |program's norm - reference's| of the
  first step's gradient as the optimizer took it, over the larger of the
  reference's norm of that leaf and of the median leaf;
- `change_gap`: the same of each leaf's change after step 3.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the last two (they move by round-off alone).

Serving: `logit_gap`, the widest gap by which a served token's logit
lies below the reference's best at its position, the reference following
the experts that the program took at each decoded position; and
`route_gap`, the widest gap by which one of those experts' router logit
lies below the reference's k-th best.
"""
from __future__ import annotations

import statistics

import torch

QUIET = 1e-3    # a leaf whose reference gradient is under QUIET x median


def counted_leaves(ref_grad: dict) -> list:
    med = statistics.median(ref_grad.values())
    return sorted(p for p, n in ref_grad.items() if n >= QUIET * med)


def worst_leaf(prog: dict, ref: dict, leaves: list) -> tuple[float, str]:
    """(the largest |prog - ref| over max(ref, the median ref), its leaf)."""
    med = statistics.median(ref[p] for p in leaves)
    return max((abs(prog[p] - ref[p]) / max(ref[p], med), p) for p in leaves)


def train_numbers(checked: dict, ref: dict) -> dict:
    """{number: value} of the program's readings against the
    reference's (its `train`'s result), and the worst leaves."""
    leaves = counted_leaves(ref["grad_norm"])
    grad, grad_leaf = worst_leaf(checked["grad_norm"], ref["grad_norm"],
                                 leaves)
    change, change_leaf = worst_leaf(checked["change_norm"],
                                     ref["change_norm"], leaves)
    loss = max(abs(a - b) / abs(b) for a, b in zip(checked["loss"],
                                                   ref["loss"]))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "worst_leaves": [grad_leaf, change_leaf]}


def train_reference(cell, weights_tree, seed, dev, mode: str = "f32",
                    rows=None) -> dict:
    """The reference's readings over the first three steps' rows (`rows`:
    a slice of each batch's rows, for a planted fault)."""
    from cardbench import generate
    batches = []
    for i in range(1, 4):
        tok = generate.train_batch(cell.traffic, cell.model, seed, i, dev)
        batches.append(tok if rows is None else tok[rows])
    return cell.reference.train(cell.model, weights_tree, batches,
                                cell.config["optimizer"], mode)


def _read(ref, res, i, tokens) -> list:
    """[(gap, route gap)] of `tokens` at request i's decoded positions."""
    rg = res["route_gap"][i]
    return [(ref.gap(res["logits"][i][j], int(tok)), float(rg[j]))
            for j, tok in enumerate(tokens)]


def serve_gaps(cell, weights_tree, sample) -> dict:
    """{"logit_gap": the widest gap of the served tokens below the
    reference's best, "route_gap": the widest gap of an expert that the
    program took at a decoded position below the reference's k-th best,
    "positions": how many were read, "widest": the four widest [gap,
    request, position]} of a sample of (prompt, served tokens, the decode
    steps' expert ids (n, layers, k) or None).

    The reference follows the program's experts at the decoded positions:
    where two experts' router logits lie within bf16's rounding, the
    program may take either, and each decoded token's keys and values
    steer the later ones, so a reference that routed on its own would
    from there on judge another sequence.  `route_gap` checks the step
    that this takes from the program."""
    ref = cell.reference
    follow = [f for _, _, f in sample]
    res = ref.sequences(cell.model, weights_tree,
                        [(p, s) for p, s, _ in sample], "f32",
                        None if any(f is None for f in follow) else follow)
    read = [(g, rg, i, j) for i, (_, served, _) in enumerate(sample)
            for j, (g, rg) in enumerate(_read(ref, res, i, served))]
    read.sort(key=lambda r: r[0], reverse=True)
    return {"logit_gap": read[0][0] if read else None,
            "route_gap": max((r[1] for r in read), default=None),
            "positions": len(read),
            "widest": [[round(g, 5), i, j] for g, _, i, j in read[:4]]}


def control_gaps(cell, weights_tree, sample, mode: str = "fp8") -> dict:
    """The control put in the program's place, read as `serve_gaps` reads
    the program: at each decoded position of the same prompts and served
    tokens, the experts that the lower precision takes and the token it
    puts first."""
    ref = cell.reference
    seqs = [(p, s) for p, s, _ in sample]
    low = ref.sequences(cell.model, weights_tree, seqs, mode)
    res = ref.sequences(cell.model, weights_tree, seqs, "f32",
                        None if low["routes"][0] is None else low["routes"])
    read = [r for i, lg in enumerate(low["logits"])
            for r in _read(ref, res, i, torch.argmax(lg, dim=-1).tolist())]
    return {"logit_gap": max(g for g, _ in read),
            "route_gap": max(rg for _, rg in read)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}), the
    limits those of a cell's limits file."""
    limits = limits["limits"]
    shown = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()
             if k in limits}
    ok = all(v is not None and v == v and v <= limits[k]
             for k, v in numbers.items() if k in limits)
    return ok and bool(shown), shown
