"""The LM decode cell (``moonlight-ep8-1t1m.decode``) at a small size on
the CPU: a run through the harness is correct and reads its metrics, the
judge fails wrong logits and a flipped route and leaves near ties out,
and the reference's copy is the package's. On the card (``-m gpu``): a
short run at the cell's own size is correct and the control is not."""
import math
from pathlib import Path

import pytest
import torch

from portbench import harness, roofline_lm

torch.set_num_threads(1)

WORKLOAD = "moonlight-ep8-1t1m.decode"
# the configuration's widths cut to a CPU test (the keys as published)
SMALL = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 4, "qk_nope_head_dim": 16,
         "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 64,
         "intermediate_size": 96, "moe_intermediate_size": 32,
         "n_routed_experts": 8, "router_experts": 16,
         "num_experts_per_tok": 2, "vocab_size": 512,
         "num_hidden_layers": 3, "max_position_embeddings": 96,
         "core_rows": 32, "core_cols": 16}
SEED = 2 ** 31 + 29


def _small_cell():
    cell = harness.load_cell(WORKLOAD)
    mix = dict(cell.mix, prompt_len=[20, 40], max_keep=16, trace_steps=2)
    return harness.Cell(cell.bench, cell.workload,
                        dict(cell.config, **SMALL), mix)


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_a_small_cpu_run_is_correct(trace):
    cell = _small_cell()
    r = harness.run_cell(cell, SEED, 0.6, trace, device="cpu", batch=4)
    assert r["correct"], r["check"]
    assert r["attempted"] == 4 * r["info"]["calls"]
    assert r["info"]["rows_compared"] >= 8
    if trace:
        assert set(r["metrics"]) >= {"device_idle.lm", "decode_mfu"}
    else:
        assert set(r["metrics"]) == {"batch_p95_ms", "setup_s"}


def test_a_stage_counts_the_device_work_queued_inside_its_spans():
    """A kernel counts to the span its launch fell in, wherever it ran
    (the card runs behind the host); one the trace holds no launch for
    counts by its own start; work outside every span counts to none."""
    gen = harness.load_module(harness.HERE / "generators" / "lm_decode.py")
    spans = [("lm.experts", 250, 400), ("lm.route", 100, 200)]
    device = [(1, 150, 160),      # launched in route, ran there
              (2, 300, 330),      # launched in route, ran in experts
              (3, 410, 420),      # launched in experts, ran after it
              (4, 500, 510),      # no launch, ran outside every span
              (5, 260, 270),      # no launch, ran inside experts
              (6, 205, 215)]      # launched between the spans
    launches = {1: 120, 2: 190, 3: 260, 6: 201}
    stages, total, unlaunched = gen.stage_ms(spans, device, launches)
    assert stages == {"lm.route": pytest.approx(40e-6),
                      "lm.experts": pytest.approx(20e-6)}
    assert total == pytest.approx(80e-6)
    assert unlaunched == pytest.approx(20e-6)
    assert gen.stage_ms([], device, launches)[0] == {}


def test_full_lanes_are_readmitted_and_their_rows_still_match():
    """A lane whose cache is full is released and re-admitted with its
    prompt as a new request inside the step; the rows kept before and
    after belong to the requests that wrote them."""
    cell = _small_cell()
    cfg = dict(cell.config, max_position_embeddings=48)
    mix = dict(cell.mix, prompt_len=[30, 40], max_keep=24)
    gen = harness.load_module(harness.HERE / "generators" / "lm_decode.py")
    program = harness.load_module(harness.HERE / "programs" / "lm_decode.py")
    params = harness.make_params(cfg, SEED, "cpu")
    call = program.build(cfg, params, "cpu")
    traffic = gen.Traffic(mix, SEED, "cpu", cfg, batch=3)
    traffic.warm(call)
    for _ in range(20):
        traffic._step(call.member)
    assert len(traffic.seqs) > 3
    assert all(len(seq) <= 48 for seq in traffic.seqs)
    for seq in traffic.seqs[3:]:                # re-admitted requests
        assert any(tuple(seq[:len(p)]) == p for p in traffic.prompts)
    win = traffic.window(call, 0.3)
    refs = harness.reference_outputs(cell, params, traffic.reference_inputs())
    v = harness.judge(cfg).verdict(win.kept, refs, cfg["check"])
    assert v["correct"] and len(win.kept) == 24


def test_the_control_is_not_correct():
    cell = _small_cell()
    v = harness.control_verdict(cell, SEED, device="cpu", batch=4)
    assert not v["correct"]
    assert v["check"]["out_gap"]["value"] > \
        10 * cell.config["check"]["out_gap_limit"]


def test_the_references_copy_is_the_packages():
    here = Path(harness.HERE)
    copy = (here / "references" / "moonlight.py").read_text()
    assert copy == (here.parent / "src" / "repro_torch" / "models" /
                    "reference_moonlight.py").read_text()
    imports = [ln for ln in copy.splitlines()
               if ln.startswith(("import ", "from "))]
    assert all("repro" not in ln and "jax" not in ln for ln in imports)


def test_the_step_bound_counts_what_the_cut_holds():
    """The grids' weights a step reads at 4 bytes: 484.6 M at the
    configuration's widths (the reckoning of its memory)."""
    config = harness.load_cell(WORKLOAD).config
    weights = sum(a * b * n for _, a, b, n in
                  roofline_lm.step_products(config, 256, 256 * 6 * 4 / 8))
    assert weights == 484_573_184
    t = roofline_lm.step_bound(config, 256, 6 * 256 * 4 / 8)
    assert 484_573_184 * 4 / 3.35e12 < t < 2 * 484_573_184 * 4 / 3.35e12
    ops = roofline_lm.step_ops(config, 256, 0.0, 0.0)
    assert ops > 2 * 256 * (484_573_184 - 4 * 8 * 3 * 2048 * 1408)


# --------------------------------------------------------------------- #
# the judge
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def answers():
    cell = _small_cell()
    cfg = cell.config
    ref = harness.reference(cfg)
    params = harness.make_params(cfg, SEED, "cpu")
    toks = torch.randint(0, 512, (60,),
                         generator=torch.Generator().manual_seed(3))
    rows = [20, 30, 45, 59]
    refs = ref.outputs(cfg, params, {0: (toks, rows)})
    return cfg, ref, params, toks, rows, refs


def _verdict(cfg, kept, refs, **over):
    judge = harness.judge(cfg)
    return judge.verdict(kept, refs, dict(cfg["check"], **over))


def test_the_judge_passes_the_reference_and_fails_wrong_logits(answers):
    cfg, _, _, _, rows, refs = answers
    kept = [((0, p), refs[(0, p)]["y"].clone()) for p in rows]
    v = _verdict(cfg, kept, refs)
    assert v["correct"] and v["check"]["out_gap"]["value"] == 0.0
    bad = [(k, y * (1 + 5 * cfg["check"]["out_gap_limit"]))
           if k[1] == 45 else (k, y) for k, y in kept]
    v = _verdict(cfg, bad, refs)
    assert not v["correct"] and v["failed"] == 1
    nan = [(k, torch.full_like(y, math.nan)) for k, y in kept[:1]]
    assert _verdict(cfg, nan, refs)["check"]["out_gap"]["value"] == "inf"
    short = [(k, y[:-1]) for k, y in kept]
    assert not _verdict(cfg, short, refs)["correct"]


@pytest.fixture(scope="module")
def flipped(answers):
    """The reference's answers when token 30, decided by a wide router
    gap, is routed in every MoE layer to its (K+1)-th choice in place of
    its K-th: the logits and the chosen experts a program that routed
    it so would give."""
    cfg, ref, params, toks, rows, refs = answers
    t = 30
    orig = ref._moe

    def moe(m, x, k, scaling, arith):
        y, gap, ids = orig(m, x, k, scaling, arith)
        s = torch.sigmoid(ref._mm(x[t:t + 1], m["gate"], arith))[0]
        order = torch.sort(s + m["gate_bias"], descending=True,
                           stable=True).indices
        K = k["K"]
        new = torch.cat([order[:K - 1], order[K:K + 1]])
        w = s[new] / (s[new].sum() + 1e-20) * scaling
        sh = m["shared"]
        yt = ref._glu(x[t:t + 1], sh["w1"], sh["w3"], sh["w2"], arith)
        for i, e in enumerate(new.tolist()):
            if 0 <= e - k["lo"] < k["held"]:
                e -= k["lo"]
                yt = yt + w[i] * ref._glu(x[t:t + 1], m["w1"][e],
                                          m["w3"][e], m["w2"][e], arith)
        y, ids = y.clone(), ids.clone()
        y[t], ids[t] = yt[0], new
        return y, gap, ids

    ref._moe = moe
    try:
        out = ref.outputs(cfg, params, {0: (toks, rows)})
    finally:
        ref._moe = orig
    return t, out


def test_the_judge_fails_a_flipped_route(answers, flipped):
    """By the logits alone, and by the routes alone."""
    cfg, _, _, _, rows, refs = answers
    t, out = flipped
    assert refs[(0, t)]["gap"] > 10 * cfg["check"]["route_margin"]
    v = _verdict(cfg, [((0, p), out[(0, p)]["y"]) for p in rows], refs)
    assert not v["correct"] and v["failed"] >= 1
    assert v["check"]["out_gap"]["value"] > 10 * cfg["check"][
        "out_gap_limit"]
    # the reference's own logits beside the flipped routes: a fault
    kept = [((0, p), (refs[(0, p)]["y"], out[(0, p)]["ids"])) for p in rows]
    v = _verdict(cfg, kept, refs)
    assert not v["correct"]
    assert v["check"]["route_faults"]["value"] == 3    # rows 30, 45, 59
    assert v["check"]["out_gap"]["value"] == 0.0


def test_a_route_flipped_at_a_near_tie_leaves_its_rows_out(answers,
                                                          flipped):
    """The same flip under a margin above the token's gaps is a near
    tie the program's rounding may swap: rows 30 on are left out (their
    logits are not compared), row 20 before it is compared."""
    cfg, _, _, _, rows, refs = answers
    t, out = flipped
    margin = 2 * float(refs[(0, 59)]["gaps"][t].max())
    kept = [((0, p), (out[(0, p)]["y"], out[(0, p)]["ids"])) for p in rows]
    v = _verdict(cfg, kept, refs, route_margin=margin, max_left_out=0.8)
    assert v["correct"] and v["info"]["left_out_share"] == 0.75
    assert v["info"]["rows_compared"] == 1
    assert v["check"]["route_faults"]["value"] == 0


def test_the_judge_leaves_near_ties_out_and_counts_them(answers):
    """A row without routes whose history holds a router gap under the
    margin is left out, whatever its logits; more than half left out is
    not correct."""
    cfg, ref, params, toks, _, _ = answers
    rows = [0, 1, 2, 59]
    refs = ref.outputs(cfg, params, {0: (toks, rows)})
    gaps = sorted({refs[(0, p)]["gap"] for p in rows})
    margin = (gaps[0] + gaps[1]) / 2           # between the two smallest
    near = [p for p in rows if refs[(0, p)]["gap"] < margin]
    assert 0 < len(near) < len(rows)
    kept = [((0, p), refs[(0, p)]["y"] * (2.0 if p in near else 1.0))
            for p in rows]
    v = _verdict(cfg, kept, refs, route_margin=margin)
    assert v["correct"]
    assert v["info"]["left_out_share"] == len(near) / len(rows)
    assert v["info"]["rows_compared"] == len(rows) - len(near)
    v = _verdict(cfg, kept, refs, route_margin=gaps[-1] + 1.0)
    assert not v["correct"] and v["info"]["left_out_share"] == 1.0
    # rows that carry their routes are left out only where a near tie
    # was routed otherwise: routed as the reference, all are compared
    kept = [((0, p), (refs[(0, p)]["y"], refs[(0, p)]["ids"]))
            for p in rows]
    v = _verdict(cfg, kept, refs, route_margin=gaps[-1] + 1.0)
    assert v["correct"] and v["info"]["left_out_share"] == 0.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct_and_the_control_is_not(card):
    cell = harness.load_cell(WORKLOAD)
    r = harness.run_cell(cell, 2 ** 31 + 77, 2.0, False, device=card)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu"
    v = harness.control_verdict(cell, 2 ** 31 + 77, device=card)
    assert not v["correct"]


@pytest.mark.gpu
def test_the_stages_on_the_card_are_the_kernels_queued_inside_them(card):
    """The traced bursts' stage readings: every stage reads, the stages
    fit in the card's work, nearly every device event has its launch,
    and a stage's kernels fit between its spans' timing events."""
    cell = harness.load_cell(WORKLOAD)
    gen = harness.load_module(harness.HERE / "generators" / "lm_decode.py")
    program = harness.load_module(harness.HERE / "programs" / "lm_decode.py")
    seed = 2 ** 31 + 91
    params = harness.make_params(cell.config, seed, card)
    call = program.build(cell.config, params, card)
    traffic = gen.Traffic(dict(cell.mix, prompt_len=[256, 512]), seed,
                          card, cell.config, batch=64)
    traffic.warm(call)
    traffic.enqueue_bursts(call)
    r = traffic.readings
    assert r[gen.COUNTER] > 0
    assert sum(r[s] for s in gen.SPANS) <= r[gen.DEVICE_TOTAL]
    assert r[gen.UNLAUNCHED] <= 0.05 * r[gen.DEVICE_TOTAL]
    for s in gen.SPANS:
        assert 0 < r[s] <= 1.02 * r[f"{s}.span_ms"], (s, r)


def test_route_check_finds_the_first_differences():
    """A near tie swapped at token 5 in MoE layer 0 changes token 5's
    deeper routes and later tokens' (a cascade, left out with it); a
    wide-gap difference nothing shallower and earlier explains is a
    fault; an earlier token's last layer is not read."""
    judge = harness.load_module(harness.HERE / "judges" / "logits.py")
    n, L, K = 10, 3, 2
    ids = torch.arange(n * L * K, dtype=torch.int16).reshape(n, L, K) % 7
    ids = torch.sort(ids.to(torch.int64), -1).values.to(torch.int16)
    gaps = torch.full((n, L), 0.05)
    gaps[5, 0] = 1e-7
    ref = {"ids": ids, "gaps": gaps, "read": L - 1}

    def routes(*where):
        r = ids.clone()
        for t, l in where:
            r[t, l, 0] = 60 + t
        return r

    assert judge.route_check(ids, ref, 1e-5) == "same"
    assert judge.route_check(routes((5, 0)), ref, 1e-5) == "near"
    assert judge.route_check(routes((5, 0), (5, 1), (8, 1)), ref,
                             1e-5) == "near"
    assert judge.route_check(routes((5, 1)), ref, 1e-5) == "fault"
    assert judge.route_check(routes((5, 0), (3, 1)), ref, 1e-5) == "fault"
    assert judge.route_check(routes((4, 2)), ref, 1e-5) == "same"
    assert judge.route_check(routes((9, 2)), ref, 1e-5) == "fault"
