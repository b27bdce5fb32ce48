"""Scripts that measure why two paths of the port disagree; run on the card, never imported by it."""
