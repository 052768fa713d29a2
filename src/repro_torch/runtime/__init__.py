"""Fault-tolerant training: the resilient loop, straggler monitoring and
the fault-injection menu."""
