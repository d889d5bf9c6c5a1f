"""Procedural data (port of ``repro.data``)."""
from repro_torch.data.images import (chars_like, cifar_like, mnist_like,
                                     sensor_frames, sensor_stream,
                                     sensor_velocity)
from repro_torch.data.pipeline import (PipelineState, SensorPipeline,
                                       TokenPipeline, embeds_batch)

__all__ = ["PipelineState", "SensorPipeline", "TokenPipeline",
           "chars_like", "cifar_like", "embeds_batch", "mnist_like",
           "sensor_frames", "sensor_stream", "sensor_velocity"]
