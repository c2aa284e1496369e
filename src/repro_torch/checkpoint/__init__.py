from repro_torch.checkpoint.manager import AsyncCheckpointer, CheckpointManager
from repro_torch.checkpoint.serializer import MODES, deserialize, serialize

__all__ = ["AsyncCheckpointer", "CheckpointManager", "MODES", "deserialize", "serialize"]
