"""The system under test for the LM decode configurations.

``repro_torch.lm.compile_lm`` maps the model (a ``deepseek_v3``
configuration: latent attention, a leading dense layer, sigmoid-routed
held experts) onto the configuration's 1T1M tile grids, once, from the
reference's float weights; :class:`Program` then serves it as a
``repro_torch.lm.LMMember`` over the mix's lanes, with the latent cache
in the configuration's ``cache_dtype``, logging the experts it routes
each position to (``route_log``: the judge compares the routing itself).
A call is ``LMMember.stream_host``: one greedy decode step over every
lane, its ids brought to page-locked host memory.
"""
from __future__ import annotations

_DTYPES = ("float32", "bfloat16")


class Program:
    """A compiled LM; :meth:`serve` makes its member (the KV lanes)."""

    def __init__(self, clm, cache_dtype):
        self.clm = clm
        self.cache_dtype = cache_dtype
        self.member = None

    def serve(self, lanes: int, cache_len: int):
        from repro_torch.lm import LMMember
        self.member = LMMember(self.clm, lanes=lanes, cache_len=cache_len,
                               cache_dtype=self.cache_dtype, route_log=True)
        return self.member


def build(config: dict, params, device):
    """The compiled model for ``params`` (the reference's published
    per-layer layout, f32 tensors on ``device``)."""
    import torch

    from repro_torch.configs.moonlight_16b_a3b import from_hf
    from repro_torch.lm import TransformerParams, compile_lm
    from repro_torch.models.model import params_from_layers

    if config["cache_dtype"] not in _DTYPES:
        raise ValueError(f"cache_dtype {config['cache_dtype']!r}")
    cfg = from_hf(config, name=config["name"])
    tree = params_from_layers(cfg, params, device=device)
    clm = compile_lm(TransformerParams(cfg, tree), system=config["system"],
                     geometry=(int(config["core_rows"]),
                               int(config["core_cols"])), device=device)
    return Program(clm, getattr(torch, config["cache_dtype"]))
