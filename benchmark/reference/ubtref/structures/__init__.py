from .instances import Detections, PaddedInstances

__all__ = ["PaddedInstances", "Detections"]
