from dsdneo_tpu_torch.protocol.x2tdma import decoder

__all__ = ["decoder"]
