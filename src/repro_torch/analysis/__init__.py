"""Offline analysis of the port's run artefacts (counterpart of
``repro.analysis``; only the plan audit is ported)."""
