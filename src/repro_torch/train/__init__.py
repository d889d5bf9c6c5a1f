"""Training substrate, ported from ``repro.train``: ``steps`` (train,
eval, prefill and decode steps; sharded under a mesh), ``checkpoint``
(the reference's atomic on-disk layout, reshard-on-load),
``train_loop`` (auto-resume, watchdog, metrics) and ``elastic``
(resume on another mesh). The launchers' pipeline, dry run and
roofline are in ``repro_torch.launch``."""
