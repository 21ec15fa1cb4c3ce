"""The stage graph: pure stages and their runner."""
