"""Fault-tolerant training runtime (counterpart of ``repro.runtime``; the
elastic re-meshing runner and the fault harness wait for ROADMAP A12)."""
