"""Scoring tables, the DFIRE potential and the docking-model record."""
