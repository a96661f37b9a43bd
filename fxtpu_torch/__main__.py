from fxtpu_torch.cli import main

if __name__ == "__main__":
    main()
