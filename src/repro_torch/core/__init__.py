"""Distributed-memory CNN primitives (paper §III); this slice ports the
single-device paths."""
