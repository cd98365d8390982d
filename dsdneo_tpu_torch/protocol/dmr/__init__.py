from dsdneo_tpu_torch.protocol.dmr import bs

__all__ = ["bs"]
