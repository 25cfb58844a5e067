from petals_tpu_torch.rpc.client import RpcClient, StreamCall
from petals_tpu_torch.rpc.server import RpcContext, RpcError, RpcServer

__all__ = ["RpcClient", "RpcContext", "RpcError", "RpcServer", "StreamCall"]
