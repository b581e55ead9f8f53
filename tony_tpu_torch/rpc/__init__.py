from tony_tpu_torch.rpc.wire import RpcServer, RpcClient, RpcError  # noqa: F401
