"""Print the JAX package's reference numbers for `chip_smoke.py`'s
`model_jax_anchor` and `moe_jax_anchor` phases (not a test module: pytest
does not collect it).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_anchor.py

Two JSON objects, one a line:

1. granite-3-2b at full width (d 2048, 32 heads over 8 KV heads, head dim
   64, ff 8192, vocab 49155), cut to 2 layers, in float32;
2. arctic-480b at full width (d 7168, 56 heads over 8 KV heads, head dim
   128, expert ff 4864, dense residual ff 4864, vocab 32000), cut to 1
   layer and 8 experts, top-2, capacity factor 1.25, in float32 (about
   6.1 GB of weights; the prefill's 97 tokens x 2 over 8 experts at a
   capacity of 32 drop assignments).

Both use the weights of `repro_torch.models.convert.numpy_params(cfg,
seed=0)` (numpy only, so the card's machine, which has no JAX, draws the
same tree).  The JAX model prefills a fixed 97-token prompt and then
decodes 8 teacher-forced tokens at positions 97..104 into a 105-position
cache.  For each of those 9 steps the script prints the logits at 32
fixed vocab ids, the argmax and the gap between the two largest logits;
for arctic also each step's `expert_load` and the sha1 of the tokens.
"""
import dataclasses
import hashlib
import json

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
    cache = [[{n: jnp.pad(c[n], ((0, 0), (0, 0), (0, STEPS), (0, 0),
                                 (0, 0))) for n in c} for c in seg]
             for seg in cache]
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


def main():
    cb.load_all()
    print(json.dumps(anchor(dataclasses.replace(
        cb.get_config("granite-3-2b"), num_layers=2, dtype="float32"))))
    print(json.dumps(anchor(dataclasses.replace(
        cb.get_config("arctic-480b"), num_layers=1, num_experts=8,
        top_k=2, capacity_factor=1.25, dtype="float32"))))


if __name__ == "__main__":
    main()
