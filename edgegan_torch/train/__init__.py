"""Network bundle (the G1/G2/E subset so far)."""
