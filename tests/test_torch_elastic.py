"""Elastic re-mesh (``repro_torch.train.elastic``): the reference's
``tests/test_elastic.py`` on gloo ranks on the CPU. Checkpoint on one
topology, resume on another; the loss trajectory must match up to
gradient-reduction order (the DP degree changes, so float summation
order changes — nothing else may).

A mesh spans the ranks of a process group, so the shrink is two
launches, as a job that lost hosts restarts: 8 ranks on a (4, 2)
(data, model) mesh train 4 steps, save a checkpoint and train 4 more
(the reference trajectory); then 4 ranks on a (2, 2) mesh ``remesh``
from that checkpoint — reshard-on-load of the global arrays — and
train the same 4 steps. The reference test's bounds: the first step
after the resume within rel 1e-4 (identical batch and parameters),
the later ones within 5e-3. Each launch has a supervisor timeout of
300 s and one thread a rank.
"""
import sys
import textwrap

from repro_torch.launch import simdev

TIMEOUT = 300.0

SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.rules import make_rules
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import AdamW, constant_schedule
    from repro_torch.sharding import axis_rules, tree_distribute
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import steps as steps_lib
    from repro_torch.train.elastic import best_mesh_for, remesh

    torch.set_num_threads(1)
    ckpt_dir, leg = sys.argv[1], sys.argv[2]
    mesh_lib.init_fleet_group(120)
    cfg = get_reduced("qwen1.5-0.5b")
    GB = 8
    pipe = TokenPipeline(vocab_size=cfg.padded_vocab, seq_len=16,
                         global_batch=GB, seed=4)
    opt = AdamW(lr=constant_schedule(1e-3), weight_decay=0.0)

    def steps_on_mesh(mesh, params, opt_state, start, n):
        rules = make_rules(cfg, mesh, "train", global_batch=GB)
        with axis_rules(mesh, rules):
            step, _ = steps_lib.make_train_step(cfg, opt, global_batch=GB,
                                                dp=mesh.size())
            losses = []
            for s in range(start, start + n):
                params, opt_state, m = step(params, opt_state,
                                            pipe.batch(s))
                losses.append(float(m["loss"]))
        return params, opt_state, losses

    if leg == "big":
        # phase 1: big mesh (8 ranks), 4 steps, checkpoint
        mesh8 = best_mesh_for(8, model_parallel=2, device="cpu")
        rules = make_rules(cfg, mesh8, "train", global_batch=GB)
        with axis_rules(mesh8, rules):
            psh = specs_lib.param_shardings(cfg, mesh8)
            whole = model_lib.init_params(cfg, 0, device="cpu")
            params, opt_state = tree_distribute(
                (whole, opt.init(whole)),
                (psh, specs_lib.opt_shardings(psh, mesh8)))
        params, opt_state, l1 = steps_on_mesh(mesh8, params, opt_state,
                                              0, 4)
        ckpt.save(ckpt_dir, 4, (params, opt_state),
                  pipeline_state=pipe.state(4).as_dict())
        # phase 2a: continue on the SAME mesh (reference)
        _, _, losses = steps_on_mesh(mesh8, params, opt_state, 4, 4)
        out = {"first": l1, "ref": losses}
    else:
        # phase 2b: node failure -> resume on a 4-rank mesh via remesh()
        mesh4 = best_mesh_for(4, model_parallel=2, device="cpu")
        pB, sB, mesh4, step0 = remesh(ckpt_dir, None, cfg, mesh=mesh4,
                                      global_batch=GB)
        assert step0 == 4
        _, _, losses = steps_on_mesh(mesh4, pB, sB, 4, 4)
        out = {"elastic": losses, "mesh": mesh_lib.mesh_axis_sizes(mesh4)}
    print(json.dumps(out))
""")


def _leg(ckpt_dir, leg, ranks):
    res = simdev.launch_local_fleet(
        [sys.executable, "-c", SCRIPT, str(ckpt_dir), leg], ranks,
        timeout=TIMEOUT, extra_env={"OMP_NUM_THREADS": "1"})
    for r in res:
        assert r.returncode == 0, r.stderr[-3000:]
    outs = [simdev.last_json_line(r.stdout) for r in res]
    assert all(o == outs[0] for o in outs)      # every rank agrees
    return outs[0]


def test_shrink_remesh_loss_trajectory_matches(tmp_path):
    big = _leg(tmp_path, "big", 8)
    small = _leg(tmp_path, "small", 4)
    assert small["mesh"] == {"data": 2, "model": 2}
    ref, elastic = big["ref"], small["elastic"]
    assert len(ref) == 4 and len(elastic) == 4
    assert big["first"][-1] > ref[-1]       # it trains
    # the first step after resume proves the restored state is exact:
    # identical data batch + identical params ⇒ identical loss up to the
    # gradient-reduction order change (DP degree differs).
    a0, b0 = ref[0], elastic[0]
    assert abs(a0 - b0) / abs(a0) < 1e-4, (ref, elastic)
    # later steps amplify that float noise through training dynamics —
    # trajectories must stay close but not bit-identical.
    for a, b in zip(ref[1:], elastic[1:]):
        assert abs(a - b) / abs(a) < 5e-3, (ref, elastic)
