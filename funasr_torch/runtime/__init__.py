"""Serving runtime of the port: the dynamic batcher and the WebSocket server."""
