"""Training: the network bundle, the TF1 RMSProp state and the fused
7-group step."""
