"""Training path: loss, step, optimizer, metrics and the Trainer loop."""
