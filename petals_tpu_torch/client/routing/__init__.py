from petals_tpu_torch.client.routing.sequence_info import RemoteSequenceInfo
from petals_tpu_torch.client.routing.sequence_manager import MissingBlocksError, RemoteSequenceManager

__all__ = ["MissingBlocksError", "RemoteSequenceInfo", "RemoteSequenceManager"]
