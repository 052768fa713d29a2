"""Language models of the reference's `repro.models.lm`; this slice ports
the one-device hybrid attention + SSD path that hymba-1.5b runs."""
