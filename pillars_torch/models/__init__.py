"""nn.Modules of the port: PFN, RPN and the detector."""
