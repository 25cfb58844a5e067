"""The span server: memory budget, compute queue, backend, continuous
batcher, RPC handler and the Server entry point."""
