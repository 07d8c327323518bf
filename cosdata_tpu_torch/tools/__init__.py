"""Measurement tools that run on the card: profiles and kernel variants."""
