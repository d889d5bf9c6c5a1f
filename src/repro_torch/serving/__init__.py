"""Slot-scheduled streaming (port of ``repro.serving``'s item-stream
schedulers)."""
from repro_torch.serving.engine import (ItemRequest, ItemRequestState,
                                        ItemStreamScheduler,
                                        KeyedItemStreamScheduler,
                                        SlotScheduler, StreamingEngine,
                                        StreamSpec)

__all__ = ["ItemRequest", "ItemRequestState", "ItemStreamScheduler",
           "KeyedItemStreamScheduler", "SlotScheduler", "StreamingEngine",
           "StreamSpec"]
