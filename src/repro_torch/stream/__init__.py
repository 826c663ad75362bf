"""Streaming one-pass sketch accumulation."""
