"""The paper's application configurations, ported: ``paper_apps``
(the five streaming apps of §IV.B and the published Tables II–VI).
The reference's LM configs come with the LM slice."""
