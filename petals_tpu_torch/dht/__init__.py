from petals_tpu_torch.dht.identity import Identity
from petals_tpu_torch.dht.node import DHTNode
from petals_tpu_torch.dht.routing import PeerAddr

__all__ = ["DHTNode", "Identity", "PeerAddr"]
