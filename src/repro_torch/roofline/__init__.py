"""Per-device cost counting and roofline terms on the H100."""
