"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``BENCHMARK.json`` at the repository root names the cells; everything a
cell needs is found here by the names it gives:

  configs/<config>.json       a configuration: the network, the core
                              system, the program, the reference and
                              the judge
  programs/<program>.py       how the system under test is built
  references/<reference>.py   the plain reference: the weights both
                              sides get and the answers
  judges/<judge>.py           the comparison that decides ``correct``
  traffic/<traffic>.json      a traffic mix's parameters
  generators/<generator>.py   the general generator a mix names
  metrics/<metric>.py         one reader a metric, end-to-end or per layer

``run.py`` is the entry point; ``harness.py`` runs a cell. The harness
imports neither JAX nor the JAX package ``repro``; the references
import nothing of ``repro_torch``.
"""
