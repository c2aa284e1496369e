from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.serializer import MODES, deserialize, serialize

__all__ = ["CheckpointManager", "MODES", "deserialize", "serialize"]
