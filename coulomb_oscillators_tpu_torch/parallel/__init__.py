"""Multi-device layer: one process per device over ``torch.distributed``."""
