"""JSON-RPC API (reference rpc/)."""
