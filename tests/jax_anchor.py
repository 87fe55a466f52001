"""Print the JAX package's reference numbers for `chip_smoke.py`'s
`model_jax_anchor` phase (not a test module: pytest does not collect it).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_anchor.py

granite-3-2b at full width (d 2048, 32 heads over 8 KV heads, head dim 64,
ff 8192, vocab 49155), cut to 2 layers, in float32, with the weights of
`repro_torch.models.convert.numpy_params(cfg, seed=0)` (numpy only, so the
card's machine, which has no JAX, draws the same tree).  The JAX model
prefills a fixed 97-token prompt and then decodes 8 teacher-forced tokens
at positions 97..104 into a 105-position cache.  For each of those 9 steps
the script prints the logits at 32 fixed vocab ids, the argmax and the gap
between the two largest logits, as one JSON object.
"""
import dataclasses
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


def main():
    cb.load_all()
    cfg = dataclasses.replace(cb.get_config("granite-3-2b"), num_layers=2,
                              dtype="float32")
    params = jax.tree_util.tree_map(jnp.asarray,
                                    convert.numpy_params(cfg, SEED))
    tokens, ids = anchor_inputs(cfg.vocab)
    logits, cache, _ = transformer.prefill(
        cfg, params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    cache = [[{n: jnp.pad(c[n], ((0, 0), (0, 0), (0, STEPS), (0, 0),
                                 (0, 0))) for n in c} for c in seg]
             for seg in cache]
    rows = [np.asarray(logits[0, -1], np.float64)]
    for i in range(PROMPT, PROMPT + STEPS):
        logits, cache, _ = transformer.decode_step(
            cfg, params, {"tokens": jnp.asarray(tokens[:, i:i + 1]),
                          "positions": jnp.full((1,), i, jnp.int32)}, cache)
        rows.append(np.asarray(logits[0, -1], np.float64))
    top2 = [np.sort(r)[-2:] for r in rows]
    print(json.dumps({
        "ids": ids.tolist(),
        "logits": [[float(f"{x:.7g}") for x in r[ids]] for r in rows],
        "argmax": [int(r.argmax()) for r in rows],
        "gap": [float(f"{t[1] - t[0]:.4g}") for t in top2],
    }))


if __name__ == "__main__":
    main()
