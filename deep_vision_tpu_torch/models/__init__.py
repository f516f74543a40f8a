"""Model zoo (``nn.Module``s, torchvision state_dict layout)."""
