"""Operator tools of the PyTorch port, run as modules
(``python -m tpu_aerial_transport_torch.tools.<name>``): the serving-fleet
harness (``fleet_local``) and its live console (``fleet_console``)."""
