"""Parameter partition specs over the model axis.

Port of ``strategy`` and ``param_specs`` of ``repro.models.sharding`` with
their rule tables.  The port has no tensor parallelism yet (model axis 1),
but the ZeRO layout (``train.zero``) skips every dim these specs mark for
``"model"`` whatever the axis size, so the specs decide which dim each
leaf shards on — e.g. the embedding shards on dim 1, not dim 0.

A spec is a tuple with ``"model"`` or ``None`` per dim.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch import tree as T

MODEL_AXIS = "model"


def strategy(cfg, n_model: int = 1) -> str:
    """Per-arch layer parallelism strategy over a model axis of
    ``n_model``: ``single`` (no TP), ``megatron_sp`` or ``pure_sp``."""
    if n_model <= 1:
        return "single"
    if cfg.n_heads % n_model == 0 and cfg.d_model >= 1024:
        return "megatron_sp"
    return "pure_sp"


_RULES: Dict[Tuple[str, int], Tuple] = {
    # embeddings / head
    ("embed", 2): (MODEL_AXIS, None),        # vocab-sharded
    ("lm_head", 2): (None, MODEL_AXIS),
    # attention
    ("wq", 2): (None, MODEL_AXIS),
    ("wk", 2): (None, MODEL_AXIS),
    ("wv", 2): (None, MODEL_AXIS),
    ("wo", 2): (MODEL_AXIS, None),           # attn out [H*hd, d] / mlp out [F, d]
    # mlp
    ("wi", 2): (None, MODEL_AXIS),
    ("wg", 2): (None, MODEL_AXIS),
    # moe — expert-block leaves [E*ep_blocks, d, ffb]
    ("router", 2): (None, None),
    ("wi", 3): (MODEL_AXIS, None, None),
    ("wg", 3): (MODEL_AXIS, None, None),
    ("wo", 3): (MODEL_AXIS, None, None),
    # mamba2
    ("m_z", 2): (None, MODEL_AXIS),
    ("m_x", 2): (None, MODEL_AXIS),
    ("m_B", 2): (None, None),
    ("m_C", 2): (None, None),
    ("m_dt", 2): (None, None),
    ("conv_x", 2): (None, MODEL_AXIS),
    ("conv_B", 2): (None, None),
    ("conv_C", 2): (None, None),
    ("A_log", 1): (MODEL_AXIS,),
    ("D", 1): (MODEL_AXIS,),
    ("dt_bias", 1): (MODEL_AXIS,),
    ("out_proj", 2): (MODEL_AXIS, None),
    # mLSTM
    ("wup", 2): (None, MODEL_AXIS),
    ("wgate", 2): (None, MODEL_AXIS),
    ("down", 2): (MODEL_AXIS, None),
    # sLSTM
    ("wz", 2): (None, MODEL_AXIS),
    ("ri", 1): (MODEL_AXIS,), ("rf", 1): (MODEL_AXIS,),
    ("rz", 1): (MODEL_AXIS,), ("ro", 1): (MODEL_AXIS,),
}

#: leaf names that can appear scan-stacked (leading period/layer dim)
_NORM_NAMES = {"norm", "norm2", "final_norm", "ln1", "ln2", "ln3",
               "q_norm", "k_norm"}


def param_specs(cfg, params: Any, n_model: int = 1) -> Any:
    """Spec tuple tree mirroring ``params`` (leaves need ``.ndim``).

    Name+ndim matched; stacked leading dims shift specs right by one.
    Unmatched leaves (gates, norms, biases) are replicated.
    """
    strat = strategy(cfg, n_model)
    pure_sp_keep = {"embed", "lm_head"}

    def spec_for(path, leaf):
        names = [str(k) for k in path]
        name = names[-1] if names else ""
        if name in _NORM_NAMES:
            return (None,) * leaf.ndim
        if strat == "pure_sp" and name not in pure_sp_keep:
            return (None,) * leaf.ndim
        if strat == "megatron_sp" and name in ("wk", "wv") and \
                cfg.n_kv_heads % max(n_model, 1) != 0:
            nd = leaf.ndim - (1 if leaf.ndim == 3 else 0)
            if nd == 2:
                return (None,) * leaf.ndim
        for stacked in (0, 1):
            key = (name, leaf.ndim - stacked)
            if key in _RULES:
                return ((None,) * stacked) + tuple(_RULES[key])
        return (None,) * leaf.ndim

    return T.map_with_path(spec_for, params)
