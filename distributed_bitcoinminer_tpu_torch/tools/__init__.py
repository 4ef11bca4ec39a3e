"""Tools of the port that run on the card (``python -m
distributed_bitcoinminer_tpu_torch.tools.<name>``)."""
