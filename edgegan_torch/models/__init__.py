"""Network modules, NCHW."""
