"""Training engine (single device; multi-device is ROADMAP.md queue A item 16)."""
