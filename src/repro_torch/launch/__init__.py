"""Launchers (counterpart of ``repro.launch``)."""
