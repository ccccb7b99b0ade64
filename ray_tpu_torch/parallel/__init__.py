"""Parallel training building blocks of the port (single device so far)."""
