"""repro_torch.launch — how a fleet of ranks is started and laid out.

  * :mod:`repro_torch.launch.simdev` — spawn and supervise localhost
    worker processes (one per rank), the heartbeat-board file
    convention shared with :mod:`repro_torch.fleet.ha`;
  * :mod:`repro_torch.launch.mesh` — the fleet's ``"chip"`` mesh over
    ranks and the gloo control-plane group.

Port of the fleet half of ``repro.launch``; the training substrate's
launchers (rules, specs, train, pipeline, dry run, roofline) are
ROADMAP Queue 1 item 9.
"""
