"""The chain data plane: pipelined encode and decode."""
