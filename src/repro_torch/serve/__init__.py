"""The exploration service: a warm Algorithm-I query engine on the card."""
