"""Frozen work counts: model FLOPs a token, kernel bounds, the peaks."""
