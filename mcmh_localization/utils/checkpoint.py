"""FilterState checkpoint/resume.

The reference has none (SURVEY.md §5: state lives in process memory and
every run restarts from scratch).  Because FilterState is an immutable
pytree of arrays, checkpointing is a flat npz dump with bit-exact resume —
including the PRNG key, so a resumed trajectory continues identically.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.filter.state import FilterState

_FIELDS = (
    "particles",
    "prev_particles",
    "weights",
    "count",
    "w_slow",
    "w_fast",
    "delta",
    "anchor",
    "anchor_streak",
)


def save_state(path: str, state: FilterState) -> None:
    arrays = {f: np.asarray(getattr(state, f)) for f in _FIELDS}
    arrays["key"] = np.asarray(jax.random.key_data(state.key))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_state(path: str) -> FilterState:
    with np.load(path) as z:
        key = jax.random.wrap_key_data(jnp.asarray(z["key"]))
        return FilterState(
            particles=jnp.asarray(z["particles"]),
            prev_particles=jnp.asarray(z["prev_particles"]),
            weights=jnp.asarray(z["weights"]),
            count=jnp.asarray(z["count"]),
            w_slow=jnp.asarray(z["w_slow"]),
            w_fast=jnp.asarray(z["w_fast"]),
            delta=jnp.asarray(z["delta"]),
            # pre-round-4 checkpoints have no anchor; the weighted-mean
            # fallback matches make_state's fresh-state initialization
            anchor=(
                jnp.asarray(z["anchor"]) if "anchor" in z
                else jnp.asarray(
                    np.average(
                        z["particles"], axis=0,
                        weights=np.maximum(z["weights"], 0.0) + 1e-30,
                    ),
                    dtype=jnp.float32,
                )
            ),
            # pre-round-5 checkpoints have no streak; 0 = no pending
            # different-mode challenge, matching make_state
            anchor_streak=(
                jnp.asarray(z["anchor_streak"], dtype=jnp.int32)
                if "anchor_streak" in z else jnp.zeros((), dtype=jnp.int32)
            ),
            key=key,
        )
