"""Consensus core of the port: parameter trees, wire layout, codecs and
the ADC-DGD runtime (counterpart of ``repro.core``)."""
