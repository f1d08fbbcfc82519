"""Network modules of the cascade (nn.Modules, NCHW / NCDHW inside)."""
