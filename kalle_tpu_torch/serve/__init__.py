"""Serving: the continuous-batching service and the streaming HTTP server."""
