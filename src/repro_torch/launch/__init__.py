"""repro_torch.launch — how a fleet of ranks is started and laid out.

  * :mod:`repro_torch.launch.simdev` — spawn and supervise localhost
    worker processes (one per rank), the heartbeat-board file
    convention shared with :mod:`repro_torch.fleet.ha`;
  * :mod:`repro_torch.launch.mesh` — the fleet's ``"chip"`` mesh over
    ranks and the gloo control-plane group; the training substrate's
    (pod, data, model) ``DeviceMesh``;
  * :mod:`repro_torch.launch.rules` — logical-axis → mesh-axis rules;
  * :mod:`repro_torch.launch.specs` — shapes (``meta``) and placements
    of parameters, optimizer state, batches and caches;
  * :mod:`repro_torch.launch.train` — the training launcher, one
    process or one rank of a group;
  * :mod:`repro_torch.launch.roofline` — the H100's roofline terms of a
    step and the collective counter;
  * :mod:`repro_torch.launch.dryrun` — every (arch × shape × mesh)
    cell's step counted on a fake group, allocating nothing;
  * :mod:`repro_torch.launch.pipeline` — the GPipe schedule over the
    ``pod`` axis, one stage a rank, forward and backward.

Port of ``repro.launch``.
"""
