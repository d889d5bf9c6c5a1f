"""The yardstick of the LM decode cells: a step's products on tile
grids, as the configuration (a ``deepseek_v3`` file) defines them.

A decode step over ``lanes`` lanes runs, in each layer, the attention's
static products (q_proj beside kv_a_proj, each head's W_kbᵀ and W_vb,
o_proj) on every lane's row; the dense layers' GLU FFN likewise; the MoE
layers' router and shared experts likewise, and each held expert's GLU
on the rows routed to it: ``assignments`` a step over all the MoE
layers, taken as evenly spread over the layers and the held experts.

A product's work is 2 · rows · d_in · d_out operations and its input,
its weights and its output each moved once, at ``roofline.io_bytes``
and ``roofline.weight_bytes`` a value (f32: the mapped path is exact
f32); its bound is the larger of operations over the TF32 peak and
bytes over the HBM rate (``roofline.bound``). :func:`step_ops` adds
what the step needs beyond the grids: the head's product and the
attention over the latent cache (scores over the latent and the RoPE
key, and the weighted sum of the latents, over ``mean_kv`` positions a
lane).
"""
from __future__ import annotations

from typing import List, Tuple

from portbench.roofline import bound


def _k(c: dict) -> dict:
    return {"d": int(c["hidden_size"]), "H": int(c["num_attention_heads"]),
            "nope": int(c["qk_nope_head_dim"]),
            "rope": int(c["qk_rope_head_dim"]), "dv": int(c["v_head_dim"]),
            "r": int(c["kv_lora_rank"]), "F": int(c["intermediate_size"]),
            "f": int(c["moe_intermediate_size"]),
            "held": int(c["n_routed_experts"]),
            "E": int(c.get("router_experts", c["n_routed_experts"])),
            "shared": int(c["n_shared_experts"]),
            "L": int(c["num_hidden_layers"]),
            "nd": int(c["first_k_dense_replace"]), "V": int(c["vocab_size"])}


def step_products(config: dict, lanes: int, assignments: float
                  ) -> List[Tuple[float, int, int, int]]:
    """(rows, d_in, d_out, matrices) of every grid product of a step."""
    k = _k(config)
    d, H, r = k["d"], k["H"], k["r"]
    attn = [(lanes, d, H * (k["nope"] + k["rope"]) + r + k["rope"], 1),
            (lanes, k["nope"], r, H), (lanes, r, k["dv"], H),
            (lanes, H * k["dv"], d, 1)]
    n_moe = k["L"] - k["nd"]
    rows = assignments / max(n_moe * k["held"], 1)
    fs = k["f"] * k["shared"]
    moe = [(lanes, d, k["E"], 1)]
    if fs:
        moe += [(lanes, d, 2 * fs, 1), (lanes, fs, d, 1)]
    moe += [(rows, d, 2 * k["f"], k["held"]), (rows, k["f"], d, k["held"])]
    dense = [(lanes, d, 2 * k["F"], 1), (lanes, k["F"], d, 1)]
    return (attn * k["L"] + dense * k["nd"] + moe * n_moe)


def step_bound(config: dict, lanes: int, assignments: float) -> float:
    """Seconds: the step's grid products' bounds summed."""
    rl = config["roofline"]
    io, wb = rl["io_bytes"], rl["weight_bytes"]
    total = 0.0
    for rows, a, b, n in step_products(config, lanes, assignments):
        ops = 2.0 * rows * a * b * n
        nbytes = n * (rows * a * io + a * b * wb + rows * b * io)
        total += bound(ops, nbytes, rl["peak"])[0]
    return total


def step_ops(config: dict, lanes: int, assignments: float,
             mean_kv: float) -> float:
    """A step's useful operations: the grid products, the head, and the
    attention over ``mean_kv`` cached positions a lane."""
    k = _k(config)
    ops = sum(2.0 * rows * a * b * n
              for rows, a, b, n in step_products(config, lanes, assignments))
    ops += 2.0 * lanes * k["d"] * k["V"]
    ops += k["L"] * 2.0 * lanes * k["H"] * mean_kv * (
        2 * k["r"] + k["rope"])
    return ops
