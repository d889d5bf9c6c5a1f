"""Training substrate, ported from ``repro.train``: ``steps`` (train,
eval, prefill and decode steps), ``checkpoint`` (the reference's atomic
on-disk layout), ``train_loop`` (auto-resume, watchdog, metrics).
``elastic`` belongs to the sharding slice (ROADMAP Queue 1 item 9)."""
