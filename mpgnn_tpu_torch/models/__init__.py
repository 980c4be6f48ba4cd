"""RelConv and MPNetm."""
