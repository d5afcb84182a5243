from .actor_pool import ActorPool
from .broadcast import broadcast, broadcast_value
from .placement_group import (PlacementGroup, placement_group,
                              remove_placement_group,
                              get_current_placement_group)
from .queue import Queue

__all__ = [
    "ActorPool", "PlacementGroup", "broadcast", "broadcast_value",
    "placement_group",
    "remove_placement_group", "get_current_placement_group", "Queue",
]
