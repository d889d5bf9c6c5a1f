"""Slot-scheduled streaming (port of ``repro.serving``): the item-stream
schedulers and the dense transformer's decode ``Engine``."""
from repro_torch.serving.engine import (Engine, ItemRequest,
                                        ItemRequestState,
                                        ItemStreamScheduler,
                                        KeyedItemStreamScheduler, Request,
                                        RequestState, SlotScheduler,
                                        StreamingEngine, StreamSpec)

__all__ = ["Engine", "ItemRequest", "ItemRequestState",
           "ItemStreamScheduler", "KeyedItemStreamScheduler", "Request",
           "RequestState", "SlotScheduler", "StreamingEngine",
           "StreamSpec"]
