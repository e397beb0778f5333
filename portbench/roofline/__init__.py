"""The benchmark's own work arithmetic and the card's published peaks."""
