"""The plain reference that decides ``correct``: low-cut design
(:mod:`.design`) and the 'same' FIR filter as a blocked FFT convolution
(:mod:`.convolve`). NumPy and plain PyTorch only; nothing of the program."""
