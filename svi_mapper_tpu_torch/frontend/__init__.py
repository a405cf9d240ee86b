"""Front-end: temporal tracking, stereo correspondence, epipolar geometry,
regional recovery."""
