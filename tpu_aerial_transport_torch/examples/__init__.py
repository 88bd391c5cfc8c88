"""Example programs of the PyTorch port, run as modules
(``python -m tpu_aerial_transport_torch.examples.<name>``)."""
