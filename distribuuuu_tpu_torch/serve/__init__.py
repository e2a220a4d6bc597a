"""Serving path of the port: engine, micro-batcher and frontend."""
