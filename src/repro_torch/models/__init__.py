"""Model code of the port (counterpart of ``repro.models``)."""
