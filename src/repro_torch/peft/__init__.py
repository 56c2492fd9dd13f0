"""Parameter-efficient fine-tuning (counterpart of repro.peft)."""
