"""Encoders (PyTorch modules in the reference state_dict layout) and weight conversion."""
