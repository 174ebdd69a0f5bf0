"""User-facing demos of the port: the classical solver on one image, and the
row-split megapixel solve under ``torch.distributed.run``."""
