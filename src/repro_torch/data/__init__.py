"""Procedural data (port of the sensor half of ``repro.data``)."""
from repro_torch.data.images import (sensor_frames, sensor_stream,
                                     sensor_velocity)
from repro_torch.data.pipeline import PipelineState, SensorPipeline

__all__ = ["PipelineState", "SensorPipeline", "sensor_frames",
           "sensor_stream", "sensor_velocity"]
