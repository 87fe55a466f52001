"""Print the JAX package's reference numbers for `chip_smoke.py`'s
`model_jax_anchor`, `moe_jax_anchor` and `recurrent_jax_anchor` phases
(not a test module: pytest does not collect it).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_anchor.py [NAME ...]

One JSON object a line, for each NAME given (all four by default, in
this order):

1. `granite`: granite-3-2b at full width (d 2048, 32 heads over 8 KV
   heads, head dim 64, ff 8192, vocab 49155), cut to 2 layers, in float32;
2. `arctic`: arctic-480b at full width (d 7168, 56 heads over 8 KV heads,
   head dim 128, expert ff 4864, dense residual ff 4864, vocab 32000),
   cut to 1 layer and 8 experts, top-2, capacity factor 1.25, in float32
   (about 6.1 GB of weights; the prefill's 97 tokens x 2 over 8 experts at
   a capacity of 32 drop assignments);
3. `recurrentgemma`: recurrentgemma-9b at full width (d 4096, LRU width
   4096, conv width 4, 16 heads over 1 of head dim 256, window 2048,
   gelu_glu ff 12288, vocab 256000, tied embeddings), cut to 3 layers (one
   (rec, rec, lattn) segment), in float32 (about 6.6 GB of weights);
4. `rwkv6`: rwkv6-7b at full width (d 4096, 64 heads of 64, channel-mix
   ff 14336, vocab 65536), cut to 2 layers, in float32.

All use the weights of `repro_torch.models.convert.numpy_params(cfg,
seed=0)` (numpy only, so the card's machine, which has no JAX, draws the
same tree).  The JAX model prefills a fixed 97-token prompt and then
decodes 8 teacher-forced tokens at positions 97..104, into a 105-position
cache for global attention (the window ring and the recurrent states
need no room).  For each of those 9 steps the script prints the logits
at 32 fixed vocab ids, the argmax and the gap between the two largest
logits, and the sha1 of the tokens; for arctic also each step's
`expert_load`.
"""
import dataclasses
import hashlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import base as cb
from repro.models import transformer
from repro_torch.models import convert

jax.config.update("jax_default_matmul_precision", "float32")

PROMPT, STEPS, SEED = 97, 8, 0


def anchor_inputs(vocab: int):
    """The 105 tokens (prompt, then the decode inputs) and the 32 vocab
    ids whose logits are compared; `chip_smoke.py` draws the same."""
    rng = np.random.default_rng(2026)
    tokens = rng.integers(0, vocab, (1, PROMPT + STEPS)).astype(np.int32)
    ids = np.sort(rng.choice(vocab, 32, replace=False)).astype(np.int64)
    return tokens, ids


def _loads(aux):
    return [np.asarray(a["expert_load"]).reshape(-1).tolist()
            for seg in aux for a in seg if "expert_load" in a]


def anchor(cfg) -> dict:
    params = jax.tree_util.tree_map(jnp.asarray,
                                    convert.numpy_params(cfg, SEED))
    tokens, ids = anchor_inputs(cfg.vocab)
    logits, cache, aux = transformer.prefill(
        cfg, params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    pad = ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0))
    cache = [[{n: jnp.pad(c[n], pad) for n in c}
              if t in ("attn", "moe") else c for c, t in zip(seg, types)]
             for seg, (types, _) in zip(cache, transformer.segments(cfg))]
    rows = [np.asarray(logits[0, -1], np.float64)]
    loads = [_loads(aux)]
    for i in range(PROMPT, PROMPT + STEPS):
        logits, cache, aux = transformer.decode_step(
            cfg, params, {"tokens": jnp.asarray(tokens[:, i:i + 1]),
                          "positions": jnp.full((1,), i, jnp.int32)}, cache)
        rows.append(np.asarray(logits[0, -1], np.float64))
        loads.append(_loads(aux))
    top2 = [np.sort(r)[-2:] for r in rows]
    out = {
        "ids": ids.tolist(),
        "logits": [[float(f"{x:.7g}") for x in r[ids]] for r in rows],
        "argmax": [int(r.argmax()) for r in rows],
        "gap": [float(f"{t[1] - t[0]:.4g}") for t in top2],
    }
    if cfg.is_moe:
        out["expert_load"] = loads
    out["tokens_sha1"] = hashlib.sha1(tokens.tobytes()).hexdigest()
    return out


# the cut configurations, by name: (arch, overrides)
ANCHORS = {
    "granite": ("granite-3-2b", dict(num_layers=2)),
    "arctic": ("arctic-480b", dict(num_layers=1, num_experts=8, top_k=2,
                                   capacity_factor=1.25)),
    "recurrentgemma": ("recurrentgemma-9b", dict(num_layers=3)),
    "rwkv6": ("rwkv6-7b", dict(num_layers=2)),
}


def main(names):
    cb.load_all()
    for name in names or ANCHORS:
        arch, kw = ANCHORS[name]
        print(json.dumps(anchor(dataclasses.replace(
            cb.get_config(arch), dtype="float32", **kw))), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
