"""Tiered keyed-state plane: hot keys in the device table, the cold tail
in a host sqlite store (the counterpart of ``windflow_tpu.state``).
Enabled with ``with_tiering(policy, hot_capacity)`` on the stateful
``Map_GPU`` / ``Filter_GPU`` builders; the dense path is unchanged when
tiering is off."""

from .tiered import (ColdStore, TierConfig, TieredKeyStore, TierPlan,
                     build_tier_blob, cold_image_from_items,
                     cold_items_from_image, hot_table_digest)

__all__ = ["ColdStore", "TierConfig", "TieredKeyStore", "TierPlan",
           "build_tier_blob", "cold_image_from_items",
           "cold_items_from_image", "hot_table_digest"]
