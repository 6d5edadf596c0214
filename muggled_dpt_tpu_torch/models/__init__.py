"""Model definitions as nn.Modules."""
